"""Hopper kernels: Monte-Carlo correctness estimation (paper Lemma 4).

Two entry points, each replacing a Pallas TPU kernel of
``src/repro/kernels/mc_correctness.py``, over one kernel body
(``src/repro_torch/csrc/mc_tie_hist.cuh``):

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
belief. The two are one function: the grouped plain version at G=1, with
every draw valid and theta = T, is the single-pool one. The TPU kernels
contracted one-hot cubes on the MXU and accumulated tiles across a
sequential grid; here each draw's votes are compared in registers (in
shared memory past 32 arms), with no padding.

What bounds them on an H100: bytes, and at the path's shapes a single
launch. ``mc_correctness`` at GreedyLLM's serve-default shape (T=8471 draws,
L=12 arms, C=12 candidates) reads about 0.4 MB, 0.12 us at 3.35 TB/s; the
grouped kernel at the serial planner's shape (G=1, C=3, T=16384, L=12)
about 0.85 MB, 0.25 us. Both lie below the time of one launch.

Design (one launch each, bitwise their plain versions):

* One thread-block cluster per (g, c): 16 blocks where all G * C clusters
  of 16 are resident on the card at once, else 8; each block sized to its
  share of the draws (up to 1024 threads), so G=1, C=3 spreads over 48
  SMs at about one draw a thread.
* L <= 32 arms — beliefs in registers, in vote-list form: the draw's
  responses are loaded into registers (as int4s where L is 8, 12, 16 or
  32), the mask is a 32-bit arm bitmask, and for each first voter of a
  class the class's belief is the sum of the voters' log weights in
  ascending arm order from 0.0 — the plain version's add order. No
  per-class array: O(n L) register work per draw for n masked arms
  whatever K is (the mask is the same for the whole block, so an unmasked
  arm costs a uniform branch).
* L > 32 arms — the wide kernel, chosen by an explicit branch on L: the
  mask is a multi-word bitmask in shared memory (one ballot per 32 arms)
  and a list of the masked arms in ascending order; each warp stages its
  32 draws' masked class ids in shared memory as int16 and each lane
  works out one draw over the masked arms only, in the same add order:
  class by class where K <= n (2 K n steps, the same for every lane), else
  from each class's first voter on, marking the class's later voters as
  it adds them (at most 2 n min(K, n) steps, each lane its own);
  ``python -m repro_torch.kernels.mc_study --wide`` times both.
  Blocks of up to 256 threads, fewer where the staging of L arms would
  pass 128 KB.
* Integer tie histograms: a draw falls in bin ``ties - 1`` where class 0
  attains the max. A bin lies below n or at least K - n - 1 (only the
  empty belief's tie reaches past n), so K bins fold into min(K, 2H)
  slots (H = 64 for L <= 32, L + 1 above): 128 slots at most for L <= 32,
  whatever K is (a template of its own folds past K = 128). Warps count bins by ballot; each block's histogram goes
  into rank 0's shared memory (distributed shared memory), and after one
  cluster barrier rank 0 runs the plain version's f64 combine (the
  lcm-scaled sum when lcm(1..K) < 2^24, K <= 18, else the chain
  ``hist_0 + hist_1 / 2 + ...`` over the bins that hold a count; the
  others add 0.0), one rounding to f32. No scratch tensor, no second
  launch.

Sizes: any L <= 1024 arms (the wide kernel's staging of L int16 class ids
a lane fits one warp at most) and any K <= 32767 classes (int16 class
ids). The wrappers refuse larger sizes, with the reason, before the
kernels are built.
"""
from __future__ import annotations

import torch

from . import _build

# kMaxClasses / kMaxArms in csrc/mc_tie_hist.cuh: the wide kernel stages
# class ids as int16, and the staging of L of them a lane fits one warp
MAX_CLASSES = 32767
MAX_ARMS = 1024
# the entry points' cluster argument: 0 lets the launch pick 16 blocks where
# all G * C clusters of 16 fit on the card at once, else 8 (the study
# `python -m repro_torch.kernels.mc_study` also times 8 and 16 forced)
AUTO_CLUSTER = 0


def _check(name, t, dtype, shape, dev) -> None:
    if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape or not t.is_contiguous():
        raise ValueError(
            f"{name}: need contiguous {dtype} {shape} on {dev}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )


def _check_sizes(kernel: str, K: int, L: int) -> None:
    if not 1 <= K <= MAX_CLASSES:
        raise ValueError(f"{kernel} takes 1 <= K <= {MAX_CLASSES} classes (class ids are "
                         f"staged as int16), got {K}")
    if L > MAX_ARMS:
        raise ValueError(f"{kernel} takes L <= {MAX_ARMS} arms (a lane's L staged class ids "
                         f"must fit one warp's shared memory), got {L}")


def _run(kernel: str, dev, *args) -> None:
    fn = _build.entry(kernel)
    with torch.cuda.device(dev):
        err = fn(*args, torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err}")


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
    _check_sizes("mc_correctness", K, L)
    if T < 1 or C > 65535:
        raise ValueError(f"mc_correctness takes T >= 1 draws and C <= 65535 masks, got T={T} C={C}")
    for name, t, dtype, shape in (
        ("responses", responses, torch.int32, (T, L)),
        ("masks", masks, torch.float32, (C, L)),
        ("log_weights", log_weights, torch.float32, (L,)),
        ("empty", empty, torch.float32, (1,)),
    ):
        _check(name, t, dtype, shape, dev)
    out = torch.empty((C,), dtype=torch.float32, device=dev)
    _run("mc_correctness", dev, responses.data_ptr(), masks.data_ptr(), log_weights.data_ptr(),
         empty.data_ptr(), out.data_ptr(), C, T, L, K, AUTO_CLUSTER)
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
    _check_sizes("mc_correctness_grouped", K, L)
    if G > 65535 or C > 65535:
        raise ValueError(f"mc_correctness_grouped takes G, C <= 65535, got G={G} C={C}")
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
    _run("mc_correctness_grouped", dev, responses.data_ptr(), masks.data_ptr(),
         log_weights.data_ptr(), empty.data_ptr(), valid.data_ptr(), theta.data_ptr(),
         out.data_ptr(), G, C, T, L, K, AUTO_CLUSTER)
    return out
