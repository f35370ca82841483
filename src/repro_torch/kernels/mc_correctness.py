"""Hopper kernel: grouped Monte-Carlo correctness estimation for the planner.

Replaces the Pallas TPU kernel ``mc_correctness_grouped_pallas`` (its body
is ``_grouped_kernel``) in ``src/repro/kernels/mc_correctness.py``. Source:
``src/repro_torch/csrc/mc_correctness_grouped.cu``; plain version:
:func:`repro_torch.kernels.ref.mc_correctness_grouped_ref`; dispatching
wrapper and launch counter: :func:`repro_torch.kernels.ops.mc_correctness_grouped`.

Per group g and candidate c: ``xi = sum_{valid t} [class 0 within TIE_TOL
of the max belief] / ties / theta_g``, where a draw's beliefs sum the log
weights of the masked arms that answered each class and empty classes
show the group's empty belief.

What bounds it on an H100: bytes, and at the planner's shapes it is
launch-bound. One launch reads the ``(G, T, L)`` int32 draws, the ``(G,
T)`` f32 valid mask and a few hundred bytes of masks, weights and empty
beliefs, and writes ``G * C`` f32 values: for the serial planner (G=1, C=3,
T=16384 draws, L=12 arms) about 0.85 MB, 0.25 us at 3.35 TB/s. The work is
``G * C * T * (L + 3K)`` compares and adds, far below the card's 67
TFLOP/s f32 rate. The TPU kernel contracted one-hot cubes on the MXU and
accumulated tiles across a sequential grid; here the votes are a
compare-and-add loop and the sum is a tree inside one block.

Design: one block of 512 threads per (g, c); threads stride over the
draws; the per-draw K-vector of beliefs lives in local memory (indexed by
the response class, K up to 128); per-thread partials go through a
fixed-shape shared-memory tree and one division by ``theta_g`` — no
atomics, so the f32 sum order never changes between runs. The sum order
differs from the plain version's exact integer sums, so the two agree to
within f32 rounding (the tests hold them to 2e-6). With only G*C blocks the
kernel leaves most SMs idle at G=1: splitting the draws over more blocks
with a second fixed-order pass is later work.
"""
from __future__ import annotations

import torch

from . import _build

MAX_CLASSES = 128


def launch_grouped(responses, masks, log_weights, empty, valid, theta,
                   num_classes: int) -> torch.Tensor:
    """Run the CUDA kernel on contiguous CUDA tensors: ``responses`` (G, T,
    L) int32, ``masks`` (G, C, L) f32, ``log_weights`` (G, L) f32,
    ``empty`` (G,) f32, ``valid`` (G, T) f32, ``theta`` (G,) f32. Returns
    ``(G, C)`` f32 xi; raises on a bad input or a failed launch."""
    if responses.dim() != 3 or masks.dim() != 3:
        raise ValueError("responses must be (G, T, L) and masks (G, C, L)")
    G, T, L = responses.shape
    C = masks.shape[1]
    dev = responses.device
    K = int(num_classes)
    if not 1 <= K <= MAX_CLASSES:
        raise ValueError(f"mc_correctness_grouped takes 1 <= K <= {MAX_CLASSES}, got {K}")
    for name, t, dtype, shape in (
        ("responses", responses, torch.int32, (G, T, L)),
        ("masks", masks, torch.float32, (G, C, L)),
        ("log_weights", log_weights, torch.float32, (G, L)),
        ("empty", empty, torch.float32, (G,)),
        ("valid", valid, torch.float32, (G, T)),
        ("theta", theta, torch.float32, (G,)),
    ):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: need contiguous {dtype} {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
    out = torch.empty((G, C), dtype=torch.float32, device=dev)
    fn = _build.entry("mc_correctness_grouped")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(responses.data_ptr(), masks.data_ptr(), log_weights.data_ptr(),
                 empty.data_ptr(), valid.data_ptr(), theta.data_ptr(),
                 out.data_ptr(), G, C, T, L, K, stream)
    if err != 0:
        raise RuntimeError(f"mc_correctness_grouped launch failed: CUDA error {err}")
    return out
