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

Design (redesigned for the H100): a group of G lanes per row, G the next
power of two >= min(K, 32), so a warp serves 32 / G rows (8 at K=4: the
router's 704 rows are 88 warps, one a block, each on an SM of its own,
where one warp a row left 28 of 32 lanes idle). The group loads its row's
responses and weights once, spread over its lanes, all loads of a lane
issued together (one memory latency, where a loop of M broadcast loads
paid one each); votes go round the group by shuffles in ascending arm order, each
lane adding the weights of the votes for its classes (``lane + G j``), so
each class's f32 sum is a fixed chain of adds — bitwise the plain version
— and classes past G are further chunks over the responses already held.
The first-max argmax is a segmented shuffle reduction (ties to the lower
index); stores run over consecutive (row, k). Any K. One launch covers
every row, so the router pays one launch per batch.
"""
from __future__ import annotations

import torch

from . import _build


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
    if K < 1:
        raise ValueError(f"belief_aggregate takes K >= 1 classes, got {K}")
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
