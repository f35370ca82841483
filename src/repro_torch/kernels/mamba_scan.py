"""Hopper kernel: the Mamba-1 selective scan (SSM-arch hot path).

Replaces the Pallas TPU kernel ``mamba_scan_pallas`` (its body is
``_kernel``) in ``src/repro/kernels/mamba_scan.py``. Source:
``src/repro_torch/csrc/mamba_scan.cu``; plain version:
:func:`repro_torch.kernels.ref.mamba_scan_ref`; dispatching wrapper and
launch counter: :func:`repro_torch.kernels.ops.mamba_scan`.

    h_t[d, n] = exp(dt_t[d] A[d, n]) h_{t-1}[d, n] + dt_t[d] x_t[d] B_t[n]
    y_t[d]    = sum_n h_t[d, n] C_t[n] + D[d] x_t[d]

returning ``(y (B, S, Din) in x's dtype, h_S (B, Din, N) f32)``. The
kernel takes the block's tensors as they are: x, B and C in bf16 or f32
(B and C may be the strided views of the block's split), widened to f32
in registers, and dt in f32 (the block adds an f32 bias before its
softplus, so either model hands over an f32 dt, in the JAX package too);
y rounded to x's dtype once, as ``y.to(x.dtype)`` would;
``h0=None`` is a zero state that is neither allocated nor read. So the
wrapper adds no cast or zero-fill pass of its own around the scan. The
block's other elementwise work runs outside it: the conv, its bias and
SiLU in one ``causal_conv1d`` launch before it, dt's f32 bias and softplus,
and the SiLU(z) gate after it.

What bounds it on an H100: exponentials. At the serving path's shape
(B=64, S=127, Din=8192, N=16 for falcon-mamba-7b; x, B, C, y bf16, dt
f32) one launch reads x (133 MB) and dt (266 MB), writes y (133 MB) and
h_last (34 MB), and reads the small B, C, A: about 567 MB, 0.17 ms at
3.35 TB/s. It takes one ``exp`` per (t, d, n), 1.07 G of them, and the
SFU issues 16 a clock per SM: at 1.98 GHz on 132 SMs that is about
0.26 ms. Each (t, d, n) also costs four f32 instructions besides its
``ex2``, so the issue slots are nearly as busy as the SFU. The TPU kernel held a (channel block, N) state in VMEM across
sequence blocks; here each channel's N states live in one thread's
registers and never touch memory between timesteps.

Design: one thread per (batch, channel), with its N <= 32 states and its
row of ``A log2(e)`` in registers (a template on the smallest of 8, 16, 32
that holds N), so each decay is one ``ex2.approx`` on the SFU; threads of
a block share a batch row. x and dt are staged through shared memory by
``cp.async`` a chunk of timesteps at a time, double-buffered, so the next
chunk is in flight while this one is scanned; B_t, C_t — common to every
channel — are read one chunk ahead into registers and stored to shared
memory after the scan. ``y_t`` is summed over n in ascending order.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import _build

MAX_STATE = 32
DTYPES = (torch.float32, torch.bfloat16)


def launch(x, dt, A, Bmat, Cmat, Dskip, h0: Optional[torch.Tensor] = None):
    """Run the CUDA kernel: x (B, S, Din) contiguous and B, C (B, S, N)
    with unit stride over N, all of one dtype (f32 or bf16); dt (B, S, Din)
    f32 contiguous; A (Din, N) f32 contiguous; D (Din,) of
    any float dtype; h0 (B, Din, N) f32 contiguous or None (zeros); all on
    one CUDA device, 1 <= N <= 32. Returns ``(y in x's dtype, h_last
    f32)``; raises on a bad input or a failed launch."""
    if x.dim() != 3 or A.dim() != 2:
        raise ValueError(f"need x (B,S,Din) and A (Din,N), got {tuple(x.shape)}, {tuple(A.shape)}")
    B, S, Din = x.shape
    N = A.shape[1]
    if not 1 <= N <= MAX_STATE:
        raise ValueError(f"mamba_scan takes 1 <= N <= {MAX_STATE}, got {N}")
    if x.dtype not in DTYPES:
        raise ValueError(f"mamba_scan takes x in {DTYPES}, got {x.dtype}")
    if B > 65535:
        raise ValueError(f"B={B} must be at most 65535 (grid limit)")
    dev = x.device
    checks = [("x", x, x.dtype, (B, S, Din), True), ("dt", dt, torch.float32, (B, S, Din), True),
              ("A", A, torch.float32, (Din, N), True),
              ("B", Bmat, x.dtype, (B, S, N), False), ("C", Cmat, x.dtype, (B, S, N), False)]
    if h0 is not None:
        checks.append(("h0", h0, torch.float32, (B, Din, N), True))
    for name, t, dtype, shape, contiguous in checks:
        if (t.device != dev or t.dtype != dtype or tuple(t.shape) != shape
                or not (t.is_contiguous() if contiguous else t.stride(2) == 1)):
            layout = "contiguous" if contiguous else "unit-stride-over-N"
            raise ValueError(
                f"{name}: need {layout} {dtype} {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} strides {t.stride()} on {t.device}"
            )
    if Dskip.shape != (Din,) or Dskip.device != dev:
        raise ValueError(f"D: need ({Din},) on {dev}, got {tuple(Dskip.shape)} on {Dskip.device}")
    d32 = Dskip.to(torch.float32).contiguous()          # Din values
    y = torch.empty_like(x)
    h_last = torch.empty((B, Din, N), dtype=torch.float32, device=dev)
    fn = _build.entry("mamba_scan")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bmat.data_ptr(), Cmat.data_ptr(),
                 Bmat.stride(0), Bmat.stride(1), Cmat.stride(0), Cmat.stride(1),
                 d32.data_ptr(), None if h0 is None else h0.data_ptr(), y.data_ptr(),
                 h_last.data_ptr(), B, S, Din, N, int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"mamba_scan launch failed: CUDA error {err}")
    return y, h_last
