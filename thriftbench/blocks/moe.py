"""``moe``: the ``attn`` block's attention half, then a top-k mixture of
experts: softmax over the k chosen router logits, capacity
``ceil(T k / E * factor)`` rounded up to 8 (``reference.model.capacity``)
over the tokens of each served batch, pairs ranked by token-major arrival
and dropped past it."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from thriftbench.blocks.attn import attention, attention_flops, attention_spec, mlp_matrices
from thriftbench.blocks.attn import flash_shape  # noqa: F401  (the attention half's launch)
from thriftbench.reference.model import bmm, capacity, mm, rmsnorm

# a token's experts depend on the other tokens of its served batch
BATCH_COUPLED = True


def spec(m: Dict):
    D, F_, E = m["d_model"], m["d_ff"], m["num_experts"]
    out = attention_spec(m) + [("router", (D, E), "mat", D), ("ewg", (E, D, F_), "mat", D)]
    if m["mlp_variant"] == "swiglu":
        out.append(("ewu", (E, D, F_), "mat", D))
    out.append(("ewd", (E, F_, D), "mat", F_))
    return out


def residual_depth(m: Dict) -> int:
    return 2 * m["num_layers"]


def moe(x: torch.Tensor, p: Dict, m: Dict, precision: str, segments) -> torch.Tensor:
    """Top-k experts over the tokens of each segment of rows (one served
    batch each), with that segment's capacity."""
    B, S, D = x.shape
    E, k = m["num_experts"], m["experts_per_token"]
    T = B * S
    flat = x.reshape(T, D)
    logits = mm(flat, p["router"], precision)
    # descending by value, the lower expert first on a tie; -0.0 below +0.0
    bits = logits.contiguous().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    idx = torch.sort(key, dim=-1, descending=True, stable=True).indices[:, :k]
    gate = torch.softmax(logits.gather(-1, idx), dim=-1)             # (T, k)
    pair_expert = idx.reshape(-1)                                    # token-major pairs
    keep = torch.zeros_like(pair_expert, dtype=torch.bool)
    lo = 0
    for rows in segments:
        hi = lo + rows * S * k
        seg = pair_expert[lo:hi]
        onehot = F.one_hot(seg, E)
        rank = (torch.cumsum(onehot, dim=0) - 1).gather(1, seg[:, None])[:, 0]
        keep[lo:hi] = rank < capacity(rows * S, m)
        lo = hi
    out = torch.zeros((T, D), dtype=torch.float32, device=x.device)
    token = torch.arange(T, device=x.device).repeat_interleave(k)
    weight = gate.reshape(-1)
    gated = m["mlp_variant"] == "swiglu"
    for e in range(E):
        sel = torch.nonzero(keep & (pair_expert == e))[:, 0]
        if sel.numel() == 0:
            continue
        xe = flat[token[sel]][None]
        h = bmm(xe, p["ewg"][e][None], precision)
        h = F.silu(h) * bmm(xe, p["ewu"][e][None], precision) if gated else \
            F.gelu(h, approximate="tanh")
        ye = bmm(h, p["ewd"][e][None], precision)[0]
        out.index_add_(0, token[sel], ye * weight[sel, None])
    return out.view(B, S, D)


def forward(h: torch.Tensor, p: Dict, m: Dict, precision: str, segments) -> torch.Tensor:
    eps = m["norm_eps"]
    h = h + attention(rmsnorm(h, p["ln1"], eps), p, m, precision)
    return h + moe(rmsnorm(h, p["ln2"], eps), p, m, precision, segments)


def flops(m: Dict, S: int) -> int:
    """A token through its k experts only, and the router."""
    D = m["d_model"]
    return attention_flops(m, S) + S * (2 * D * m["num_experts"] + m["experts_per_token"]
                                        * 2 * mlp_matrices(m) * D * m["d_ff"])


def launches(m: Dict) -> Dict[str, int]:
    return {"flash_attention": 1}
