"""``mla``: a pre-norm block of latent attention (MLA, DeepSeek-V2/V3) and a
SwiGLU MLP, a residual around each; Moonlight-16B-A3B's dense first layer.

Queries at full rank (``q_lora_rank`` 0): ``x wq`` gives each head
``qk_nope_head_dim`` columns and ``qk_rope_head_dim`` with RoPE. ``x wkv_a``
gives the latent ``c`` (``kv_lora_rank``), RMSNormed by ``kv_norm``, and
``k_pe`` (``qk_rope_head_dim``), rotated and shared by every head; ``c
wkv_b`` gives each head's ``k_nope`` and v (``v_head_dim``). Causal softmax
attention at ``1 / sqrt(qk_nope_head_dim + qk_rope_head_dim)`` (published
without ``rope_scaling``), then ``wo``.

RoPE rotates the two halves of q_pe and k_pe (``reference.model.rope``), as
the port and this reference do for every block: the published checkpoint's
interleaved q_pe/k_pe layout is a fixed permutation of the columns of
``wq`` and ``wkv_a`` that feed them, so random weights drawn in either
layout are the same model. In the program the attention is one
``flash_attention`` launch, its v zero-padded to q/k's head dim.

Plain f32 PyTorch (e4m3 products under the ``fp8`` control), TF32 off."""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from thriftbench.metrics.arith import visible_pairs
from thriftbench.reference.model import _no_tf32 as no_tf32
from thriftbench.reference.model import mm, rmsnorm, rope

BATCH_COUPLED = False


def dims(m: Dict):
    """(heads, latent rank, q/k columns without RoPE, with RoPE, v's)."""
    if m.get("q_lora_rank"):
        raise ValueError("the mla reference takes queries at full rank only (q_lora_rank 0)")
    return (m["num_heads"], m["kv_lora_rank"], m["qk_nope_head_dim"], m["qk_rope_head_dim"],
            m["v_head_dim"])


def attention_spec(m: Dict):
    """The attention half's tensors and the second norm, in draw order."""
    D = m["d_model"]
    H, r, dn, dr, dv = dims(m)
    return [("ln1", (D,), "zeros", 0), ("wq", (D, H * (dn + dr)), "mat", D),
            ("wkv_a", (D, r + dr), "mat", D), ("kv_norm", (r,), "zeros", 0),
            ("wkv_b", (r, H * (dn + dv)), "mat", r), ("wo", (H * dv, D), "mat", H * dv),
            ("ln2", (D,), "zeros", 0)]


def swiglu_spec(D: int, F_: int):
    return [("wg", (D, F_), "mat", D), ("wu", (D, F_), "mat", D), ("wd", (F_, D), "mat", F_)]


def spec(m: Dict):
    return attention_spec(m) + swiglu_spec(m["d_model"], m["d_ff"])


def residual_depth(m: Dict) -> int:
    return 2 * m["num_layers"]


def attention(x: torch.Tensor, p: Dict, m: Dict, precision: str) -> torch.Tensor:
    B, S, _ = x.shape
    H, r, dn, dr, dv = dims(m)
    q = mm(x, p["wq"], precision).view(B, S, H, dn + dr)
    q = torch.cat([q[..., :dn], rope(q[..., dn:], m["rope_theta"])], dim=-1)
    kv = mm(x, p["wkv_a"], precision)
    c = rmsnorm(kv[..., :r], p["kv_norm"], m["norm_eps"])
    k_pe = rope(kv[..., r:].reshape(B, S, 1, dr), m["rope_theta"])
    kvb = mm(c, p["wkv_b"], precision).view(B, S, H, dn + dv)
    k = torch.cat([kvb[..., :dn], k_pe.expand(B, S, H, dr)], dim=-1)
    v = kvb[..., dn:]
    scores = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(dn + dr)
    pos = torch.arange(S, device=x.device)
    visible = pos[:, None] >= pos[None, :]
    if m.get("window", 0) > 0:
        visible &= (pos[:, None] - pos[None, :]) < m["window"]
    scores = scores.masked_fill(~visible, float("-inf"))
    out = torch.einsum("bhst,bthd->bshd", torch.softmax(scores, dim=-1), v)
    return mm(out.reshape(B, S, H * dv), p["wo"], precision)


def swiglu(x: torch.Tensor, p: Dict, precision: str) -> torch.Tensor:
    return mm(F.silu(mm(x, p["wg"], precision)) * mm(x, p["wu"], precision), p["wd"], precision)


def forward(h: torch.Tensor, p: Dict, m: Dict, precision: str, segments) -> torch.Tensor:
    no_tf32()
    eps = m["norm_eps"]
    h = h + attention(rmsnorm(h, p["ln1"], eps), p, m, precision)
    return h + swiglu(rmsnorm(h, p["ln2"], eps), p, precision)


def attention_flops(m: Dict, S: int) -> int:
    """The four projections at every position; scores and PV, 2 H (q/k dim
    + v dim) a visible causal (and windowed) pair."""
    D = m["d_model"]
    H, r, dn, dr, dv = dims(m)
    return (S * 2 * (D * H * (dn + dr) + D * (r + dr) + r * H * (dn + dv) + H * dv * D)
            + 2 * H * (dn + dr + dv) * visible_pairs(S, m.get("window", 0)))


def flops(m: Dict, S: int) -> int:
    return attention_flops(m, S) + S * 2 * 3 * m["d_model"] * m["d_ff"]


def launches(m: Dict) -> Dict[str, int]:
    return {"flash_attention": 1}


def flash_shape(m: Dict) -> Dict[str, int]:
    """The launch's heads (every head its own kv head: k_pe is broadcast, k_nope
    is per head), the q/k and v head dims, and the window (0: causal only)."""
    H, _, dn, dr, dv = dims(m)
    return {"heads": H, "kv_heads": H, "qk_dim": dn + dr, "v_dim": dv,
            "window": m.get("window", 0)}
