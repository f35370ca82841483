"""Hopper kernels: Monte-Carlo correctness estimation (paper Lemma 4).

Two kernels, each replacing a Pallas TPU kernel of
``src/repro/kernels/mc_correctness.py``:

* ``mc_correctness`` (:func:`launch`) replaces ``mc_correctness_pallas``:
  the xi of C candidate masks over one pool's theta shared draws, the
  estimator behind GreedyLLM on xi (``McXiEstimator``). Source
  ``src/repro_torch/csrc/mc_correctness.cu``; plain version
  :func:`repro_torch.kernels.ref.mc_correctness_ref`; wrapper and launch
  counter :func:`repro_torch.kernels.ops.mc_correctness`.
* ``mc_correctness_grouped`` (:func:`launch_grouped`) replaces
  ``mc_correctness_grouped_pallas`` (its body is ``_grouped_kernel``): the
  same per group g over the planner's stacked draws. Source
  ``src/repro_torch/csrc/mc_correctness_grouped.cu``; plain version
  :func:`repro_torch.kernels.ref.mc_correctness_grouped_ref`; wrapper
  :func:`repro_torch.kernels.ops.mc_correctness_grouped`.

Per candidate c: ``xi = sum_{valid t} [class 0 within TIE_TOL of the max
belief] / ties / theta``, where a draw's beliefs sum the log weights of the
masked arms that answered each class and empty classes show the empty
belief. The TPU kernels contracted one-hot cubes on the MXU and accumulated
tiles across a sequential grid (the single-pool one padded theta with -1
rows and subtracted their credit); here the votes are a compare-and-add
loop per draw, with no padding.

What bounds them on an H100: bytes, and at the path's shapes they are
launch-bound. ``mc_correctness`` at the serve defaults (T=16843 draws, L=12
arms, C=12 candidates) reads about 0.8 MB, 0.24 us at 3.35 TB/s; the work,
``C * T * (L + 3K)`` compares and adds, is far below the card's 67 TFLOP/s
f32 rate. The grouped kernel at the serial planner's shape (G=1, C=3,
T=16384, L=12) reads about 0.85 MB, 0.25 us.

Design of ``mc_correctness``: a grid of (ceil(T / 256), C) blocks, one
thread per (draw, candidate), so even one candidate spreads over T / 256
SMs. Each thread's K-vector of beliefs lives in local memory (indexed by the
response class, K up to 128). A draw contributes one count to a tie-count
histogram bin; warps count bins with ballots and each block writes its
integer histogram to a scratch tensor; a second launch sums the blocks in
order in 64-bit integers and does the plain version's f64 combine — so the
kernel equals its plain version bit for bit, on every run.

Design of ``mc_correctness_grouped``: one block of 512 threads per (g, c);
threads stride over the draws; per-thread f32 partials go through a
fixed-shape shared-memory tree and one division by ``theta_g`` — no
atomics, so the f32 sum order never changes between runs. That order
differs from the plain version's exact integer sums, so the two agree to
within f32 rounding (the tests hold them to 2e-6). With only G*C blocks it
leaves most SMs idle at G=1.
"""
from __future__ import annotations

import torch

from . import _build

MAX_CLASSES = 128
DRAWS_PER_BLOCK = 256          # kDraws in csrc/mc_correctness.cu


def _check(name, t, dtype, shape, dev) -> None:
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"{name}: need contiguous {dtype} {shape} on {dev}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )


def launch(responses, masks, log_weights, empty, num_classes: int) -> torch.Tensor:
    """Run the CUDA kernel on contiguous CUDA tensors: ``responses`` (T, L)
    int32, ``masks`` (C, L) f32, ``log_weights`` (L,) f32, ``empty`` (1,)
    f32. Returns ``(C,)`` f32 xi; raises on a bad input or a failed
    launch."""
    if responses.dim() != 2 or masks.dim() != 2:
        raise ValueError("responses must be (T, L) and masks (C, L)")
    T, L = responses.shape
    C = masks.shape[0]
    dev = responses.device
    K = int(num_classes)
    if not 1 <= K <= MAX_CLASSES:
        raise ValueError(f"mc_correctness takes 1 <= K <= {MAX_CLASSES}, got {K}")
    if T < 1 or C > 65535:
        raise ValueError(f"mc_correctness takes T >= 1 draws and C <= 65535 masks, got T={T} C={C}")
    for name, t, dtype, shape in (
        ("responses", responses, torch.int32, (T, L)),
        ("masks", masks, torch.float32, (C, L)),
        ("log_weights", log_weights, torch.float32, (L,)),
        ("empty", empty, torch.float32, (1,)),
    ):
        _check(name, t, dtype, shape, dev)
    n_blocks = -(-T // DRAWS_PER_BLOCK)
    hist = torch.empty((n_blocks, C, K), dtype=torch.int32, device=dev)
    out = torch.empty((C,), dtype=torch.float32, device=dev)
    fn = _build.entry("mc_correctness")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(responses.data_ptr(), masks.data_ptr(), log_weights.data_ptr(),
                 empty.data_ptr(), hist.data_ptr(), out.data_ptr(), C, T, L, K,
                 n_blocks, stream)
    if err != 0:
        raise RuntimeError(f"mc_correctness launch failed: CUDA error {err}")
    return out


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
        _check(name, t, dtype, shape, dev)
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
