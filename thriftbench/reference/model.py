"""The plain reference of the arms' forward pass: float32 PyTorch, layer by
layer, from weights it draws itself (:mod:`thriftbench.weights`).

It follows the published architectures as the program's configurations
name them: pre-norm blocks with RMSNorm scaled by ``1 + scale``, each layer
the ``forward`` of its block type's file, ``thriftbench/blocks/<type>.py``
(GQA attention with SwiGLU or GELU MLPs, top-k mixture of experts, Mamba-1),
built from the helpers here: :func:`mm`, :func:`bmm`, :func:`rmsnorm`,
:func:`rope` and the MoE :func:`capacity` rule. It imports nothing of the
program.

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

from thriftbench.weights import derived, draw_ends, draw_layer, load_block

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


def capacity(tokens: int, m: Dict) -> int:
    cap = math.ceil(tokens * m["experts_per_token"] / m["num_experts"] * m["expert_capacity_factor"])
    return max(8, -(-cap // 8) * 8)


def block(h: torch.Tensor, btype: str, p: Dict, m: Dict, precision: str, segments) -> torch.Tensor:
    """One layer of type ``btype``, its residuals included: the ``forward`` of
    ``thriftbench/blocks/<btype>.py``."""
    return load_block(btype).forward(h, p, m, precision, segments)


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
