"""Hopper kernel: batched belief aggregation for the serving router.

Replaces the Pallas TPU kernel ``belief_aggregate_pallas`` (its body is
``_kernel``) in ``src/repro/kernels/belief_aggregate.py``. Source:
``src/repro_torch/csrc/belief_aggregate.cu``; plain version:
:func:`repro_torch.kernels.ref.belief_aggregate_ref`; dispatching wrapper
and launch counter: :func:`repro_torch.kernels.ops.belief_aggregate`.

Per row b: ``beliefs[b, k] = sum_m w[b, m] [resp[b, m] == k]`` over the
invoked arms (``resp >= 0``), empty classes set to the row's empty belief,
and the first-max argmax.

What bounds it on an H100: bytes, and at the serving shapes not even those
— it is launch-bound. One launch reads ``R * M`` int32 responses and f32
weights plus ``R`` empty beliefs and writes ``R * K`` f32 beliefs and ``R``
predictions: at the router's prefix-expanded shape (``R = B (T+1)`` rows
for B=64 queries, M=T=12 waves, K=4) that is 832 rows and about 100 KB,
0.03 us at 3.35 TB/s, against a few microseconds to launch any kernel.
The TPU kernel contracted a (rows, M, K) one-hot cube on the MXU; here the
vote sum is a compare-and-add loop, with no tensor cores (a one-hot
product is not worth them).

Design: one warp per row, lanes over the classes (K padded to a multiple
of 32, at most 128, kept in registers), the M responses read in ascending
order so each class's f32 sum is a fixed chain of adds — bitwise the plain
version — and a warp-shuffle first-max argmax. One launch covers every
row, so the router pays one launch per batch.
"""
from __future__ import annotations

import torch

from . import _build

MAX_CLASSES = 128


def launch(responses: torch.Tensor, log_weights: torch.Tensor,
           empty: torch.Tensor, num_classes: int):
    """Run the CUDA kernel: ``responses`` (B, M) int32, ``log_weights``
    (B, M) f32 and ``empty`` (B,) f32, all contiguous on one CUDA device.
    Returns ``(beliefs (B, K) f32, predictions (B,) int32)``; raises on a
    bad input or a failed launch."""
    if responses.dim() != 2:
        raise ValueError(f"responses must be (B, M), got {tuple(responses.shape)}")
    B, M = responses.shape
    dev = responses.device
    K = int(num_classes)
    if not 1 <= K <= MAX_CLASSES:
        raise ValueError(f"belief_aggregate takes 1 <= K <= {MAX_CLASSES}, got {K}")
    for name, t, dtype, shape in (
        ("responses", responses, torch.int32, (B, M)),
        ("log_weights", log_weights, torch.float32, (B, M)),
        ("empty", empty, torch.float32, (B,)),
    ):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: need contiguous {dtype} {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
    bel = torch.empty((B, K), dtype=torch.float32, device=dev)
    pred = torch.empty((B,), dtype=torch.int32, device=dev)
    fn = _build.entry("belief_aggregate")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(responses.data_ptr(), log_weights.data_ptr(), empty.data_ptr(),
                 bel.data_ptr(), pred.data_ptr(), B, M, K, stream)
    if err != 0:
        raise RuntimeError(f"belief_aggregate launch failed: CUDA error {err}")
    return bel, pred
