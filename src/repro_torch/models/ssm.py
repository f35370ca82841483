"""Mamba-1 selective state-space math (the port of ``repro/models/ssm.py``).

Recurrence (per channel d, state n):
    h_t = exp(dt_t * A[d,n]) * h_{t-1} + dt_t * B_t[n] * x_t[d]
    y_t = sum_n C_t[n] * h_t[d,n] + D[d] * x_t[d]

The JAX package runs a chunked ``lax.scan`` (on a TPU the ``mamba_scan``
Pallas kernel substitutes); the port runs the fused scan
:func:`repro_torch.kernels.ops.mamba_scan` — the hand-written CUDA kernel
on the card, the sequential plain version on the CPU — so ``chunk`` has no
effect; its ``h_last`` is a prefill's decode state. Decode takes one plain
f32 step, :func:`ssm_decode_step`, as in the JAX package.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.kernels import ops


def causal_conv1d(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, state: Optional[torch.Tensor] = None
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depthwise causal conv along time. x (B, S, D), w (D, K), b (D,).

    Returns (y (B, S, D), new_state (B, K-1, D)): y from
    :func:`repro_torch.kernels.ops.causal_conv1d` — one launch of the
    hand-written kernel on the card, on the CPU the unrolled shifted
    multiply-add in f32 as the JAX package writes it (not ``F.conv1d``) —
    and the new state from :func:`conv_state`.
    """
    return ops.causal_conv1d(x, w, b, state), conv_state(x, w.shape[1], state)


def conv_state(x: torch.Tensor, K: int, state: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The last K-1 inputs of ``cat([state, x])`` along time (B, K-1, D),
    ``state`` None meaning zeros: the view ``x[:, S-K+1:]`` where there is
    no state and S >= K-1, else a small ``cat`` (a decode step, a prefill
    shorter than K-1)."""
    B, S, D = x.shape
    if state is None and S >= K - 1:
        return x[:, S - K + 1:]
    if state is None:
        state = torch.zeros((B, K - 1, D), dtype=x.dtype, device=x.device)
    return torch.cat([state, x], dim=1)[:, S:]


def selective_scan(
    x: torch.Tensor,        # (B, S, Din) post-conv activations
    dt: torch.Tensor,       # (B, S, Din) softplus'd step sizes
    A: torch.Tensor,        # (Din, N) negative real
    Bmat: torch.Tensor,     # (B, S, N)
    Cmat: torch.Tensor,     # (B, S, N)
    Dskip: torch.Tensor,    # (Din,)
    h0: Optional[torch.Tensor] = None,
    chunk: int = 256,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Selective scan from ``h0`` (zeros if None). Returns (y (B, S, Din) in
    x's dtype, h_last (B, Din, N) f32). ``chunk`` is accepted for the JAX
    signature and has no effect: the kernel is the fused scan. The block's
    tensors go to the kernel as they are — bf16 or f32, B and C as views of
    their split — and it widens, scans and rounds y itself."""
    del chunk
    return ops.mamba_scan(x, dt, A, Bmat, Cmat, Dskip, h0)


def ssm_decode_step(
    x: torch.Tensor,        # (B, Din) single-step post-conv activation
    dt: torch.Tensor,       # (B, Din)
    A: torch.Tensor,        # (Din, N)
    Bvec: torch.Tensor,     # (B, N)
    Cvec: torch.Tensor,     # (B, N)
    Dskip: torch.Tensor,    # (Din,)
    h: torch.Tensor,        # (B, Din, N) f32
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single recurrence step for serving: ``(y (B, Din) in x's dtype,
    h_new)``, all math in f32. ``h`` is updated in place (``a h``, then
    ``+ dt x B``: the same two roundings as a fresh ``a * h + ...``) and
    returned as ``h_new``."""
    x32, dt32 = x.float(), dt.float()
    a = torch.exp(dt32[..., None] * A.float()[None])               # (B,Din,N)
    h.mul_(a).add_((dt32 * x32)[..., None] * Bvec[:, None, :].float())
    y = torch.einsum("bdn,bn->bd", h, Cvec.float())
    y = y + x32 * Dskip[None].float()
    return y.to(x.dtype), h
