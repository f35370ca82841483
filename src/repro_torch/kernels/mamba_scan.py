"""Hopper kernel: the Mamba-1 selective scan (SSM-arch hot path).

Replaces the Pallas TPU kernel ``mamba_scan_pallas`` (its body is
``_kernel``) in ``src/repro/kernels/mamba_scan.py``. Source:
``src/repro_torch/csrc/mamba_scan.cu``; plain version:
:func:`repro_torch.kernels.ref.mamba_scan_ref`; dispatching wrapper and
launch counter: :func:`repro_torch.kernels.ops.mamba_scan`.

    h_t[d, n] = exp(dt_t[d] A[d, n]) h_{t-1}[d, n] + dt_t[d] x_t[d] B_t[n]
    y_t[d]    = sum_n h_t[d, n] C_t[n] + D[d] x_t[d]

returning ``(y (B, S, Din), h_S (B, Din, N))``, all f32.

What bounds it on an H100: bytes. One launch reads x and dt and writes y,
each (B, S, Din) f32, plus h0 and h_last (B, Din, N) and the small B, C:
at the serving path's shape (B=64, S=127, Din=8192, N=16 for
falcon-mamba-7b) about 870 MB, 260 us at 3.35 TB/s. Its ~5 flops and one
``exp`` per (t, d, n) — 1.1 G exponentials on the path — come second, but
not by much on the CUDA cores. The TPU kernel held a (channel block, N)
state in VMEM across sequence blocks; here each channel's N states live in
one thread's registers and never touch memory between timesteps.

Design: one thread per (batch, channel), with its N <= 32 states and its
row of A in registers (a template on the smallest of 8, 16, 32 that holds
N); threads of a block share a batch row, so x and dt loads coalesce, and
B_t, C_t — common to every channel — are staged through shared memory 64
timesteps at a time. ``y_t`` is summed over n in ascending order.
"""
from __future__ import annotations

import torch

from . import _build

MAX_STATE = 32


def launch(x, dt, A, Bmat, Cmat, Dskip, h0):
    """Run the CUDA kernel: x and dt (B, S, Din), A (Din, N), B and C
    (B, S, N), D (Din,), h0 (B, Din, N), all contiguous f32 on one CUDA
    device, 1 <= N <= 32. Returns ``(y, h_last)``; raises on a bad input or
    a failed launch."""
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"need x (B,S,Din) and A (Din,N), got {tuple(x.shape)}, {tuple(A.shape)}")
    B, S, Din = x.shape
    N = A.shape[1]
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"mamba_scan takes 1 <= N <= {MAX_STATE}, got {N}")
    if B > 65535:
        raise ValueError(f"B={B} must be at most 65535 (grid limit)")
    dev = x.device
    for name, t, shape in (
        ("x", x, (B, S, Din)), ("dt", dt, (B, S, Din)), ("A", A, (Din, N)),
        ("B", Bmat, (B, S, N)), ("C", Cmat, (B, S, N)), ("D", Dskip, (Din,)),
        ("h0", h0, (B, Din, N)),
    ):
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: need contiguous float32 {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
    y = torch.empty_like(x)
    h_last = torch.empty_like(h0)
    fn = _build.entry("mamba_scan")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(),
                 Cmat.data_ptr(), Dskip.data_ptr(), h0.data_ptr(), y.data_ptr(),
                 h_last.data_ptr(), B, S, Din, N, stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan launch failed: CUDA error {err}")
    return y, h_last
