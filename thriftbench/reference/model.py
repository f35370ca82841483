"""The plain reference of the arms' forward pass: float32 PyTorch, layer by
layer, from weights it draws itself (:mod:`thriftbench.weights`).

It follows the published architectures as the program's configurations
name them: pre-norm blocks with RMSNorm scaled by ``1 + scale``; GQA
attention with RoPE rotating the two halves of each head, causal and (when
``window`` > 0) windowed; SwiGLU or tanh-GELU MLPs; top-k mixture of
experts with softmax over the k chosen logits and capacity
``ceil(T k / E * factor)`` rounded up to 8, pairs ranked by token-major
arrival and dropped past it; Mamba-1 blocks (causal depthwise conv, SiLU,
selective scan, SiLU gate). It imports nothing of the program.

``precision`` is ``"f32"`` (the reference) or ``"fp8"`` (the control): every
projection, MLP, router, expert and head product is taken on e4m3 copies of
both operands, each row of the activations and each output column of the
weights scaled to the e4m3 range, and accumulated in f32; everything else
stays f32. The attention products stay f32 in both.

TF32 is off for every product here.
"""
from __future__ import annotations

import math
from typing import Dict

import torch
import torch.nn.functional as F

from thriftbench.weights import derived, draw_ends, draw_layer

PRECISIONS = ("f32", "fp8")
E4M3_MAX = 448.0


def _no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _q8(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``t`` rounded to e4m3 with one scale per slice along ``dim``."""
    t = t.float()
    scale = t.abs().amax(dim=dim, keepdim=True).clamp(min=1e-30) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).float() * scale


def mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """x (..., K) @ w (K, N) in f32, or on e4m3 operands under ``fp8``."""
    if precision == "fp8":
        return _q8(x, -1) @ _q8(w, -2)
    return x.float() @ w.float()


def bmm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    """(E, C, K) x (E, K, N) batched, as :func:`mm`."""
    if precision == "fp8":
        return torch.bmm(_q8(x, -1), _q8(w, -2))
    return torch.bmm(x.float(), w.float())


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x = x.float()
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * (1.0 + scale.float())


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x (B, S, H, hd): the first half of each head rotated against the second."""
    S, hd = x.shape[1], x.shape[-1]
    half = hd // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32, device=x.device) / half))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)


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


def capacity(tokens: int, m: Dict) -> int:
    cap = math.ceil(tokens * m["experts_per_token"] / m["num_experts"] * m["expert_capacity_factor"])
    return max(8, -(-cap // 8) * 8)


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


def mamba(x: torch.Tensor, p: Dict, m: Dict, precision: str) -> torch.Tensor:
    B, S, _ = x.shape
    Din, N, R, K = m["d_inner"], m["ssm_state"], m["ssm_dt_rank"], m["ssm_conv"]
    xz = mm(x, p["w_in"], precision)
    xs, z = xz[..., :Din], xz[..., Din:]
    w = p["conv_w"].float()                                          # (Din, K)
    padded = F.pad(xs, (0, 0, K - 1, 0))                             # zeros before t = 0
    conv = sum(padded[:, i:i + S] * w[:, i] for i in range(K)) + p["conv_b"].float()
    u = F.silu(conv)
    proj = mm(u, p["w_x"], precision)
    dt = F.softplus(mm(proj[..., :R], p["w_dt"], precision) + p["b_dt"].float())
    Bm, Cm = proj[..., R:R + N], proj[..., R + N:]
    A = -torch.exp(p["a_log"].float())                               # (Din, N)
    h = torch.zeros((B, Din, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        h = torch.exp(dt[:, t, :, None] * A) * h + (dt[:, t] * u[:, t])[..., None] * Bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]))
    y = torch.stack(ys, dim=1) + u * p["d_skip"].float()
    return mm(y * F.silu(z), p["w_out"], precision)


def block(h: torch.Tensor, btype: str, p: Dict, m: Dict, precision: str, segments) -> torch.Tensor:
    eps = m["norm_eps"]
    if btype == "ssm":
        return h + mamba(rmsnorm(h, p["ln"], eps), p, m, precision)
    h = h + attention(rmsnorm(h, p["ln1"], eps), p, m, precision)
    x = rmsnorm(h, p["ln2"], eps)
    return h + (moe(x, p, m, precision, segments) if btype == "moe" else mlp(x, p, m, precision))


@torch.no_grad()
def answer_logits(model: Dict, tokens: torch.Tensor, seed: int, arm: int,
                  precision: str = "f32", segments=None) -> torch.Tensor:
    """Logits (B, vocab_size) f32 at the last of ``tokens`` (B, S) — the
    position that predicts the answer slot — for arm ``arm`` drawn from
    ``seed``. ``segments`` (row counts, default one of B) are the batches the
    rows were served in: a MoE layer's capacity counts each one's tokens.
    Runs on ``tokens.device``, one layer's weights at a time."""
    if precision not in PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    _no_tf32()
    m = derived(model)
    dev = tokens.device
    segments = [tokens.shape[0]] if segments is None else list(segments)
    if sum(segments) != tokens.shape[0]:
        raise ValueError(f"segments {segments} do not cover {tokens.shape[0]} rows")
    ends = draw_ends(model, seed, arm, dev)
    h = ends["tok"][tokens.long()].float()
    for i, btype in enumerate(m["layer_types"]):
        p = draw_layer(model, i, seed, arm, dev)
        h = block(h, btype, p, m, precision, segments)
        del p
    last = rmsnorm(h[:, -1], ends["final_norm"], m["norm_eps"])
    head = ends["head"] if "head" in ends else ends["tok"].T
    return mm(last, head, precision)[:, :m["vocab_size"]]
