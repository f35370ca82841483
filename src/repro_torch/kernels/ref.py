"""Plain PyTorch versions of the port's kernels.

The CPU tests hold these to the JAX package, the kernel wrappers in
:mod:`repro_torch.kernels.ops` use them for tensors on the CPU, and
``chip_smoke.py`` holds each CUDA kernel to its plain version on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.belief import aggregate_log_beliefs_batch
from repro_torch.core.mc import _masked_xi_core, xi_from_responses


def belief_aggregate_ref(responses, log_weights, empty_belief, num_classes):
    """(log_beliefs (B, K) f32, predictions (B,) int32); votes summed in
    ascending arm order, first-max argmax."""
    beliefs = aggregate_log_beliefs_batch(responses, log_weights, num_classes, empty_belief)
    return beliefs, torch.argmax(beliefs, dim=-1).to(torch.int32)


# (C,) f32 xi of C masks over one pool's (T, L) draws: the estimator's exact
# form (the group core at G=1, every draw valid, theta = T), rounded to f32
mc_correctness_ref = xi_from_responses


def mc_correctness_grouped_ref(responses, masks, log_weights, empty_belief,
                               valid, theta, num_classes):
    """(G, C) f32 xi: the planner's exact grouped core, rounded to f32."""
    theta = torch.as_tensor(theta, device=responses.device).to(torch.float64)
    return _masked_xi_core(
        responses, masks, log_weights, empty_belief, valid, theta, num_classes,
    ).to(torch.float32)


def flash_attention_ref(q, k, v, causal=True, window=0):
    """Direct softmax attention in f32 (no blocking), out in q's dtype: the
    same function as ``repro/models/attention.py::direct_attention``. v's
    head dim may be below q/k's (latent attention): out takes v's, the
    scores q's 1 / sqrt(hd). A row
    that sees no key gets the mean of v here (softmax over equal masked
    scores), where the kernel writes 0; self-attention never has one."""
    # imported here: models.attention imports kernels.ops, which imports this module
    from repro_torch.models.attention import direct_attention

    return direct_attention(q, k, v, causal=causal, window=window)


def rglru_scan_ref(log_a, gated, h0):
    """Sequential ``h_t = exp(log_a_t) h_{t-1} + u_t``: ``(h (B, S, D),
    h_last (B, D))``."""
    h, hs = h0, []
    for t in range(log_a.shape[1]):
        h = torch.exp(log_a[:, t]) * h + gated[:, t]
        hs.append(h)
    return torch.stack(hs, dim=1), h


def mamba_scan_ref(x, dt, A, Bmat, Cmat, Dskip, h0=None):
    """Sequential Mamba-1 scan, one timestep at a time, in f32: ``(y (B, S,
    Din) in x's dtype, h_last (B, Din, N) f32)``. The inputs are widened to
    f32 (B and C may be strided views), ``h0=None`` starts from zeros and y
    is rounded to x's dtype once, as the JAX package's ``selective_scan``
    does. Never forms a (B, S, Din, N) tensor — the JAX package's chunked
    form would, ~4 GB per chunk at full width."""
    f32 = lambda t: t.to(torch.float32)
    x32, dt32, A32, B32, C32, D32 = map(f32, (x, dt, A, Bmat, Cmat, Dskip))
    h = (torch.zeros((x.shape[0], x.shape[2], A.shape[1]), dtype=torch.float32, device=x.device)
         if h0 is None else f32(h0))
    ys = []
    for t in range(x.shape[1]):
        dt_t, x_t = dt32[:, t], x32[:, t]                              # (B, Din)
        h = torch.exp(dt_t[..., None] * A32) * h + (dt_t * x_t)[..., None] * B32[:, t, None, :]
        ys.append((h * C32[:, t, None, :]).sum(-1) + D32 * x_t)
    return torch.stack(ys, dim=1).to(x.dtype), h


def causal_conv1d_ref(x, w, b, state=None, silu=False):
    """Depthwise causal conv along time, unrolled as the JAX package writes
    it: y (B, S, D) in x's dtype from x (B, S, D), w (D, K), b (D,) and the
    K-1 inputs before x, ``state`` (B, K-1, D) (None: zeros). Each tap a
    shifted multiply-add in f32 onto 0, then the bias, rounded to x's dtype
    once; with ``silu``, ``F.silu`` of that (in f32, rounded again)."""
    B, S, D = x.shape
    K = w.shape[1]
    if state is None:
        state = torch.zeros((B, K - 1, D), dtype=x.dtype, device=x.device)
    xt = torch.cat([state, x], dim=1)                       # (B, S+K-1, D)
    y = 0
    for i in range(K):
        y = y + xt[:, i:i + S, :].float() * w[:, i][None, None, :].float()
    y = (y + b[None, None, :]).to(x.dtype)
    return F.silu(y) if silu else y
