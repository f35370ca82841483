"""``attn``: a dense pre-norm block. GQA attention with RoPE rotating the two
halves of each head, causal and (when ``window`` > 0) windowed, then a
SwiGLU or tanh-GELU MLP; a residual around each. Its attention is one
``flash_attention`` launch in the program. The ``moe`` block shares the
attention half."""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from thriftbench.metrics.arith import visible_pairs
from thriftbench.reference.model import mm, rmsnorm, rope

BATCH_COUPLED = False


def attention_spec(m: Dict):
    """The attention half's tensors and the second norm, in draw order."""
    D, H, G, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], m.get("head_dim", 0)
    if m.get("qkv_bias"):
        raise ValueError("qkv_bias is not drawn by this benchmark")
    return [("ln1", (D,), "zeros", 0), ("wq", (D, H * hd), "mat", D),
            ("wk", (D, G * hd), "mat", D), ("wv", (D, G * hd), "mat", D),
            ("wo", (H * hd, D), "mat", H * hd), ("ln2", (D,), "zeros", 0)]


def mlp_matrices(m: Dict) -> int:
    return 3 if m["mlp_variant"] == "swiglu" else 2


def spec(m: Dict):
    D, F_ = m["d_model"], m["d_ff"]
    out = attention_spec(m) + [("wg", (D, F_), "mat", D)]
    if m["mlp_variant"] == "swiglu":
        out.append(("wu", (D, F_), "mat", D))
    out.append(("wd", (F_, D), "mat", F_))
    return out


def residual_depth(m: Dict) -> int:
    return 2 * m["num_layers"]


def attention(x: torch.Tensor, p: Dict, m: Dict, precision: str) -> torch.Tensor:
    B, S, _ = x.shape
    H, G, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    q = rope(mm(x, p["wq"], precision).view(B, S, H, hd), m["rope_theta"])
    k = rope(mm(x, p["wk"], precision).view(B, S, G, hd), m["rope_theta"])
    v = mm(x, p["wv"], precision).view(B, S, G, hd)
    rep = H // G                                   # query head h reads kv head h // rep
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    scores = torch.einsum("bshd,bthd->bhst", q, k) / math.sqrt(hd)
    pos = torch.arange(S, device=x.device)
    visible = pos[:, None] >= pos[None, :]
    if m.get("window", 0) > 0:
        visible &= (pos[:, None] - pos[None, :]) < m["window"]
    scores = scores.masked_fill(~visible, float("-inf"))
    out = torch.einsum("bhst,bthd->bshd", torch.softmax(scores, dim=-1), v)
    return mm(out.reshape(B, S, H * hd), p["wo"], precision)


def mlp(x: torch.Tensor, p: Dict, m: Dict, precision: str) -> torch.Tensor:
    if m["mlp_variant"] == "swiglu":
        hidden = F.silu(mm(x, p["wg"], precision)) * mm(x, p["wu"], precision)
    else:
        hidden = F.gelu(mm(x, p["wg"], precision), approximate="tanh")
    return mm(hidden, p["wd"], precision)


def forward(h: torch.Tensor, p: Dict, m: Dict, precision: str, segments) -> torch.Tensor:
    eps = m["norm_eps"]
    h = h + attention(rmsnorm(h, p["ln1"], eps), p, m, precision)
    return h + mlp(rmsnorm(h, p["ln2"], eps), p, m, precision)


def attention_flops(m: Dict, S: int) -> int:
    """The projections at every position, scores and PV over the visible
    causal (and windowed) pairs only."""
    D, H, G, hd = m["d_model"], m["num_heads"], m["num_kv_heads"], m["head_dim"]
    return (S * 2 * D * (H + 2 * G) * hd + S * 2 * H * hd * D
            + 4 * H * hd * visible_pairs(S, m.get("window", 0)))


def flops(m: Dict, S: int) -> int:
    return attention_flops(m, S) + S * 2 * mlp_matrices(m) * m["d_model"] * m["d_ff"]


def launches(m: Dict) -> Dict[str, int]:
    return {"flash_attention": 1}


def flash_shape(m: Dict) -> Dict[str, int]:
    """What this layer's ``flash_attention`` launch attends over: query and kv
    heads, the q/k and the v head dims, and the window (0: causal only)."""
    return {"heads": m["num_heads"], "kv_heads": m["num_kv_heads"], "qk_dim": m["head_dim"],
            "v_dim": m["head_dim"], "window": m.get("window", 0)}
