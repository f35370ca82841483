"""``mla_moe``: the ``mla`` block's latent attention, then a mixture of
experts beside shared experts; Moonlight-16B-A3B's layers 1-26.

The router is DeepSeek-V3's ``noaux_tc`` with one expert group: the f32
router product's sigmoid scores; each token's k experts are those of the
largest ``score + router_bias`` (descending, the lower expert first on a
tie, -0.0 below +0.0), weighed by their scores without the bias,
normalised to sum 1 (over the sum + 1e-20), times ``routed_scaling``. Capacity ``ceil(T k / E * factor)`` rounded up
to 8 (``reference.model.capacity``) over the tokens of each served batch,
pairs ranked by token-major arrival and dropped past it: the port's rule,
where the published model drops nothing. The shared experts are one SwiGLU
of ``num_shared_experts`` x ``expert_d_ff``, added to the routed output.

Drawn: ``router_bias`` as a (E,) matrix of fan-in 400, std 0.05, so that
the bias moves which experts are chosen (a zero bias, the published
starting value, would leave the biased choice untested); ``ewd`` and the
shared ``wd`` scaled by 1 / sqrt(2 L) as every residual projection, and
``ewd`` drawn at fan-in ``expert_d_ff x routed_scaling^2``, a std
1 / routed_scaling of its plain one, so that the routed sum's published
factor leaves a random layer's output at the scale of an unscaled one.
Without it a random 27-layer stack amplifies a bf16 rounding nearly as far
as an e4m3 one, and no comparison could tell the two apart: at the plain
draw the reference itself, computed in bf16, reads a mean gap near 0.1
against f32, as the program does (``thriftbench/witness.py --plain-ewd``
with ``--control bf16``).

Plain f32 PyTorch (e4m3 products under the ``fp8`` control), TF32 off."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from thriftbench.blocks.mla import attention, attention_flops, attention_spec, no_tf32
from thriftbench.blocks.mla import flash_shape  # noqa: F401  (the attention half's launch)
from thriftbench.blocks.mla import residual_depth, swiglu, swiglu_spec  # noqa: F401
from thriftbench.reference.model import bmm, capacity, mm, rmsnorm

# a token's experts depend on the other tokens of its served batch
BATCH_COUPLED = True
BIAS_FAN_IN = 400             # the selection bias's std, 1 / sqrt(400) = 0.05


def shared_width(m: Dict) -> int:
    return m["num_shared_experts"] * m["expert_d_ff"]


def spec(m: Dict):
    if m.get("router_scoring") != "sigmoid":
        raise ValueError("the mla_moe reference routes by sigmoid scores")
    D, E, Fe = m["d_model"], m["num_experts"], m["expert_d_ff"]
    out = attention_spec(m) + [("router", (D, E), "mat", D),
                               ("router_bias", (E,), "mat", BIAS_FAN_IN),
                               ("ewg", (E, D, Fe), "mat", D), ("ewu", (E, D, Fe), "mat", D),
                               ("ewd", (E, Fe, D), "mat", Fe * m["routed_scaling"] ** 2)]
    if shared_width(m):
        out += swiglu_spec(D, shared_width(m))
    return out


def route(logits: torch.Tensor, p: Dict, m: Dict):
    """(T, k) experts and f32 weights of the sigmoid router."""
    scores = torch.sigmoid(logits)
    bits = (scores + p["router_bias"].float()).contiguous().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    idx = torch.sort(key, dim=-1, descending=True, stable=True).indices[:, :m["experts_per_token"]]
    w = scores.gather(-1, idx)
    return idx, w / (w.sum(dim=-1, keepdim=True) + 1e-20) * m["routed_scaling"]


def moe(x: torch.Tensor, p: Dict, m: Dict, precision: str, segments) -> torch.Tensor:
    """The routed experts over the tokens of each segment of rows (one served
    batch each), with that segment's capacity, plus the shared experts."""
    B, S, D = x.shape
    E, k = m["num_experts"], m["experts_per_token"]
    T = B * S
    flat = x.reshape(T, D)
    idx, gate = route(mm(flat, p["router"], precision), p, m)
    pair_expert = idx.reshape(-1)                                    # token-major pairs
    keep = torch.zeros_like(pair_expert, dtype=torch.bool)
    lo = 0
    for rows in segments:
        hi = lo + rows * S * k
        seg = pair_expert[lo:hi]
        rank = (torch.cumsum(F.one_hot(seg, E), dim=0) - 1).gather(1, seg[:, None])[:, 0]
        keep[lo:hi] = rank < capacity(rows * S, m)
        lo = hi
    out = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    token = torch.arange(T, device=x.device).repeat_interleave(k)
    weight = gate.reshape(-1)
    for e in range(E):
        sel = torch.nonzero(keep & (pair_expert == e))[:, 0]
        if sel.numel() == 0:
            continue
        xe = flat[token[sel]][None]
        h = F.silu(bmm(xe, p["ewg"][e][None], precision)) * bmm(xe, p["ewu"][e][None], precision)
        out.index_add_(0, token[sel], bmm(h, p["ewd"][e][None], precision)[0] * weight[sel, None])
    if shared_width(m):
        out = out + swiglu(flat, p, precision)
    return out.view(B, S, D)


def forward(h: torch.Tensor, p: Dict, m: Dict, precision: str, segments) -> torch.Tensor:
    no_tf32()
    eps = m["norm_eps"]
    h = h + attention(rmsnorm(h, p["ln1"], eps), p, m, precision)
    return h + moe(rmsnorm(h, p["ln2"], eps), p, m, precision, segments)


def flops(m: Dict, S: int) -> int:
    """A token through its k routed experts and the shared ones, and the
    router; not the capacity's padding."""
    D = m["d_model"]
    return attention_flops(m, S) + S * (2 * D * m["num_experts"] + 2 * 3 * D * (
        m["experts_per_token"] * m["expert_d_ff"] + shared_width(m)))


def launches(m: Dict) -> Dict[str, int]:
    return {"flash_attention": 1}
