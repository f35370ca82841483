"""RG-LRU recurrent block math (the port of ``repro/models/rglru.py``).

Diagonal gated linear recurrence:
    r_t = sigmoid(x_t W_r)                  (recurrence gate)
    i_t = sigmoid(x_t W_i)                  (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)  (per-channel decay, c = 8)
    h_t = a_t * h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

The JAX package scans with ``jax.lax.associative_scan`` (on a TPU the
``rglru_scan`` Pallas kernel substitutes); the port runs the recurrence
through :func:`repro_torch.kernels.ops.rglru_scan` — the hand-written CUDA
kernel on the card, the sequential plain version on the CPU (its
``h_last`` is a prefill's decode state). Decode takes one plain step,
:func:`rglru_decode_step`, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

RGLRU_C = 8.0


def rglru_gates(
    x: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor, br: torch.Tensor,
    bi: torch.Tensor, lam: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (log_a, gated_input), both (..., Dr) float32."""
    x32 = x.float()
    r = torch.sigmoid(x32 @ wr.float() + br)
    i = torch.sigmoid(x32 @ wi.float() + bi)
    log_a = -RGLRU_C * F.softplus(lam.float()) * r
    a2 = torch.exp(2.0 * log_a)
    gated = torch.sqrt(torch.clamp(1.0 - a2, min=1e-12)) * i * x32
    return log_a, gated


def rglru_scan(
    log_a: torch.Tensor,     # (B, S, Dr)
    gated: torch.Tensor,     # (B, S, Dr)
    h0: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """h_t = a_t h_{t-1} + u_t from ``h0`` (zeros if None). Returns
    (h (B, S, Dr), h_last (B, Dr)), f32."""
    if h0 is None:
        B, _, D = log_a.shape
        h0 = torch.zeros((B, D), dtype=torch.float32, device=log_a.device)
    return ops.rglru_scan(log_a, gated, h0)


def rglru_decode_step(
    x: torch.Tensor, wr: torch.Tensor, wi: torch.Tensor, br: torch.Tensor,
    bi: torch.Tensor, lam: torch.Tensor, h: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One recurrence step: x (B, Dr), h (B, Dr) f32 -> ``(h_new in x's
    dtype, h_new f32)``. ``h`` is updated in place (``exp(log_a) h``, then
    ``+ gated``: the same two roundings as a fresh ``exp(log_a) * h +
    gated``) and returned as the f32 ``h_new``."""
    log_a, gated = rglru_gates(x, wr, wi, br, bi, lam)
    h.mul_(torch.exp(log_a)).add_(gated)
    return h.to(x.dtype), h
