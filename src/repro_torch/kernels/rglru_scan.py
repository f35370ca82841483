"""Hopper kernel: the RG-LRU diagonal linear recurrence (hybrid-arch hot path).

Replaces the Pallas TPU kernel ``rglru_scan_pallas`` (its body is
``_kernel``) in ``src/repro/kernels/rglru_scan.py``. Source:
``src/repro_torch/csrc/rglru_scan.cu``; plain version:
:func:`repro_torch.kernels.ref.rglru_scan_ref`; dispatching wrapper and
launch counter: :func:`repro_torch.kernels.ops.rglru_scan`.

``h_t = exp(log_a_t) * h_{t-1} + u_t`` elementwise over channels, from
``h0``; returns every ``h_t`` and ``h_S``, all f32.

What bounds it on an H100: bytes. One launch reads log_a and u and writes
h, each (B, S, D) f32, plus h0 and h_last: at the serving path's shape
(B=64, S=127, D=4096 for recurrentgemma-9b) about 400 MB, 120 us at
3.35 TB/s; its 3 flops per element are nothing beside that. The TPU kernel
held a lane block of state in VMEM across sequence blocks; here the state
of one channel is one register.

Design: one thread per (batch, channel), neighbouring threads on
neighbouring channels so each timestep's loads and stores coalesce; a
sequential loop over S carries h in a register (``fmaf(exp(log_a), h, u)``)
and writes h_t, then h_last. B*D threads (262,144 on the path) fill the
card; the loop is unrolled so loads of later timesteps overlap the chain.
"""
from __future__ import annotations

import torch

from . import _build


def launch(log_a: torch.Tensor, u: torch.Tensor, h0: torch.Tensor):
    """Run the CUDA kernel: ``log_a`` and ``u`` (B, S, D), ``h0`` (B, D), all
    contiguous f32 on one CUDA device. Returns ``(h (B, S, D), h_last (B,
    D))``; raises on a bad input or a failed launch."""
    if log_a.dim() != 3:
        raise ValueError(f"log_a must be (B, S, D), got {tuple(log_a.shape)}")
    B, S, D = log_a.shape
    dev = log_a.device
    for name, t, shape in (("log_a", log_a, (B, S, D)), ("u", u, (B, S, D)),
                           ("h0", h0, (B, D))):
        if t.device != dev or t.dtype != torch.float32 or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: need contiguous float32 {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
    h = torch.empty_like(log_a)
    h_last = torch.empty_like(h0)
    fn = _build.entry("rglru_scan")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(log_a.data_ptr(), u.data_ptr(), h0.data_ptr(), h.data_ptr(),
                 h_last.data_ptr(), B, S, D, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan launch failed: CUDA error {err}")
    return h, h_last
