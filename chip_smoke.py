#!/usr/bin/env python3
"""Drive the PyTorch port's serving path — the router and the continuous-
batching front door — GreedyLLM and the paper's baselines on one CUDA card
and check them.

    python3 chip_smoke.py

TF32 is off for the whole run (``torch.backends.cuda.matmul.allow_tf32``
and ``torch.backends.cudnn.allow_tf32``): f32 results are compared below.

Phases:

1. report — the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build — compile every CUDA kernel of ``src/repro_torch/csrc`` (six, one
   ``nvcc`` each, all started together; timed as set-up), then count the
   tensor-core instructions (``HGMMA``/``HMMA``) in the ``flash_attention``
   library's SASS (``cuobjdump -sass``): the phase fails at 0;
3. kernels vs plain — each router kernel against its plain PyTorch version
   on the same CUDA tensors, bitwise, or the phase fails:
   ``belief_aggregate`` (beliefs and predictions) at (130, 12, 77), at the
   router's prefix-expanded shape for K=4 and K=77 and at M=40 for K=129,
   200 and 1000; ``mc_correctness_grouped`` at planner shapes (G in {1, 8},
   C=3, T=16384, L=12, K in {4, 77}; G=1 at K=128; G=8 at L=32, the last
   register kernel, at K=200, and at L=33 and 64, the wide kernel; G=1 at
   L=40, K=200) and ``mc_correctness`` on ``sample_pool_responses`` draws
   at the Fig. 11 shape (T=8000, L=8, C=8, K=4), the serve defaults (T =
   ``theta_for(0.1, 0.01, 0.95, 12)`` = 8471, L=12, C=12) at K=4, 77 and
   128, one candidate over T=300 (less than a block), a ragged last block,
   L=32, and the wide kernel at L=33, 64 and 128 (C=8, K=4) and at L=40,
   K=1000. Then one call of each of the three at its path shape under
   ``torch.profiler`` must show exactly one kernel launch and allocate
   nothing but its outputs. Past the limits of earlier versions, both mc
   kernels bitwise at T=300: L=1100 K=4 (int16 staging), L=12 and L=64 at
   K=40000 (folded bins; int32 staging), L=1100 K=40000 and L=2100 K=4 (no
   staging), each timed; and the grouped kernel at G=65537 and at
   C=65537, the single one at C=65537 (chunked launches);
4. route — the serve defaults (12 arms, K=4, 6 clusters, history 2000,
   batches of 64, eps 0.1, delta 0.01): uniform-budget batches (batched
   planner + device wave loop) and mixed-budget batches (serial planner,
   which scores candidates with ``mc_correctness_grouped`` under
   ``use_kernel``), with ``use_kernel`` off and on, each held against the
   same routes run by the port on the CPU: plans (sets, xi, cost, p*),
   predictions, schedules, costs and beliefs bitwise on both planes;
5. K=77 — one batch over a 77-class label space with ``use_kernel=True``;
6. launches — both router kernels' launch counters, zeroed just before
   phase 4, must be above 0 after phase 5; then one route of 64 is timed
   cold and warm on the card, and each kernel is checked against its plain
   version and timed at the shape the main path gave it;
7. model kernels vs plain — ``flash_attention`` in bf16 (the tensor-core
   kernel, 2e-2 against the f32 plain version) at the two LM arms' shapes,
   at S=37 with T=45, with window 5, at hd 16, 32 and 128 and at query /
   kv head ratios 1, 3 and 16, and in f32 (the CUDA-core kernel) with and
   without windows, hd 64 and 256 (2e-5); ``rglru_scan`` at (64, 127,
   4096) and (3, 37, 200) (1e-5); ``mamba_scan`` at the falcon-mamba path
   case — bf16 x, B and C, B and C strided views of one (B, S, R + 2N)
   projection, dt in f32 as the block gives it, no initial state: h_last
   within 3e-4, the bf16 y within 3e-4 plus one rounding to nearest
   (2^-8 |y|) of the plain version's unrounded f32 y — and in f32 at (64, 127, 8192, 16) and (2, 37,
   96, 8) with nonzero initial states (3e-4);
8. models — smollm-135m, recurrentgemma-9b and falcon-mamba-7b at full
   width in f32, cut to one pattern unit of depth (1, 3 and 1 layers) so
   the CPU side takes seconds: the same weights forward on the card and on
   the CPU, logits within 1e-3;
9. LM-arm route — the three models at full width and depth in bf16 as
   ``LMArm``s (seeded init on the card) over ``make_token_task(K=4,
   seq_len=128, vocab=512)``: calibrate on 256 history queries, route a
   uniform-budget and a mixed-budget batch of 64 through
   ``ThriftRouter(use_kernel=True)``. The kernels' launch counters, zeroed
   before this phase, are read after the two routes and ``flash_attention``,
   ``rglru_scan``, ``mamba_scan`` and ``belief_aggregate`` must each be
   above 0; costs stay within budget, a second route of each batch repeats
   the first, and the plans equal those of a router planning on the CPU,
   bitwise. Then the same two batches through a ``BatchScheduler``
   (``max_batch`` 64, ``max_inflight`` 2, no faults, no labels, counters
   zeroed before it): predictions, costs and stop waves equal the router's
   own routes of the same admission groups, and the three model kernels
   and ``belief_aggregate`` launch; then one batch with faults on smollm
   (timeout 0.3, error 0.2): smollm classifies exactly its unfailed cells,
   counted row by row, and only smollm is charged failures;
10. timing — each model kernel at the LM-arm route's shapes and dtypes
    (``mamba_scan`` with bf16 x, strided bf16 B, C, f32 dt and no initial
    state, bound
    by its exponentials at the card's maximum SM clock);
11. GreedyLLM on MC xi — GreedyLLM (Alg. 1) scoring candidates with
    ``McXiEstimator(use_kernel=True)`` on the card, held to the same run on
    the CPU (equal picks and final xi): (a) the Fig. 11 setting of
    ``benchmarks/paper_benches.py::xi_vs_gamma`` (40 seeds, 8 arms, theta
    8000, K=4, budget 1.0), printing its ``mean_xi_gain`` against greedy on
    gamma; (b) every cluster of the serve-default workload (K=4, 2000-query
    history) at the five budgets of ``examples/budget_sweep.py`` with theta
    ``theta_for(0.1, 0.01, max p, 12)``, then a K=77 workload at 5e-4.
    ``mc_correctness``'s launch counter, zeroed before the phase, must be
    above 0 after it; one selection is timed on the host clock (median of
    5) and the kernel at the shape the phase gave it. An ``[earlier
    kernels]`` line then sets each redesigned kernel's time (``flash_attention``,
    ``mamba_scan``, ``mc_correctness``, ``mc_correctness_grouped``,
    ``belief_aggregate``) beside
    its earlier version's recorded time (not measured in this run, and so
    kept out of the ``kernels`` line);
12. budget sweep — ``repro_torch.budget_sweep`` at the example's defaults
    (600 queries, 3000 history, 5 budgets): ThriftLLM, SurGreedy, cascade,
    top-k, single and blender with the router on the card and on the CPU;
    every column's (accuracy, mean cost) must be equal, and every
    budget-aware column within its budget;
13. 40 arms — the serve defaults over a 40-arm oracle pool (K=4), past
    the register kernels' 32 arms: a uniform-budget and a mixed-budget
    batch of 64 with ``use_kernel=True``, card vs CPU bitwise as in phase
    4, then GreedyLLM with ``McXiEstimator(use_kernel=True)`` over the same
    40 arms at budgets 1e-5 and 1e-4, picks and xi card vs CPU. The launch
    counters, zeroed just before the phase, must show ``belief_aggregate``,
    ``mc_correctness_grouped`` and ``mc_correctness`` above 0 after it;
14. scheduler — ``launch/serve.py --queries 500 --budget 1e-4 --fault-rate
    0.1 --drift-after 250 --probe-rate 0.02`` at ``--qps 0`` on the port's
    ``BatchScheduler`` (``max_batch`` 64; faults on every arm, seed 7; a
    ``FeedbackLog`` with probes; a ``CostLedger`` whose tenant "acme", every
    other request, is limited to 80% of its spend in an unlimited run, with
    downgrade tiers 2.5e-5, 5e-5, 1e-4), blocks of 64 submitted and drained
    in turn with their labels recorded, then one mixed-budget block of 64
    admitted by ``flush()`` (its plan misses plan serially): ``use_kernel``
    off and on, each on the card and on the CPU, every block's
    predictions, costs, planned costs, clusters, budgets, stop waves, modes
    and request ids, every counter and the ledger's snapshot bitwise. The
    launch counters are zeroed before and read after each card stream;
    with ``use_kernel`` on, ``belief_aggregate`` and
    ``mc_correctness_grouped`` must be above 0. Then ``--qps 5000 --slo-ms
    50`` on the card (Poisson arrivals, the same faults and probes, no
    drift, no ledger; timed, not compared) and the
    device's idle share of one profiled floodgates stream. A
    ``[scheduler]`` line prints qps, p50/p99, accuracy, planes, flushes,
    plan counters, failures, drifts, ledger rejections and downgrades and
    launches per setting.

Two lines before the last is a JSON object listing every kernel with its
launches, error, bound and times — ``ms``/``plain_ms``/``library_ms`` are
device time per call from a ``torch.profiler`` trace of n calls between
spin kernels that holds n times one call's kernel rows (else it is taken
again, and a ``[profiler traces]`` line lists the short ones; a
single-launch kernel whose traces all lost rows is read from its mean
kernel row, ``ms_source`` says so; a ``[profiler rows]`` line counts the
rows of bare and of bracketed traces), ``call_ms`` the
CUDA-event wall time per call, host dispatch included; a router kernel's
``launches`` count phases 4-5 and its ``lm_route_launches`` phase 9, a
model kernel's ``launches`` phase 9, ``mc_correctness``'s phase 11; the
three router kernels' ``wide_pool_launches`` count phase 13, the two
router kernels' ``scheduler_launches`` phase 14's ``use_kernel`` stream,
and ``lm_scheduler_launches`` the LM arms' scheduler run in phase 9; the
two ``mc_correctness`` rows carry ``lifted``, their phase-3 cases past
the limits of earlier versions, timed.
``flash_attention`` is listed at the
recurrentgemma shape with both path shapes under ``by_shape``. Every row
carries ``launch_floor_ms``, the device time of a one-element ``zero_()``
in this run: the least a single launch costs. The three router kernels'
rows carry ``bitwise`` (their every check in this run was exact) and
``call_ms``; the two ``mc_correctness`` rows carry ``wide``, the wide
kernel at L=64 (K=4) at the row's path shape otherwise. The line
before the last is the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. Any failed phase raises and the script
exits non-zero; without a CUDA device, or without the repository's
``src/repro_torch`` beside it, it exits non-zero before printing a result.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12        # H100 SXM device memory rate
F32_OPS_PER_S = 67e12            # H100 SXM f32 rate outside the tensor cores
BF16_OPS_PER_S = 989e12          # H100 SXM dense bf16 tensor-core rate
FLASH_BF16_ATOL = 2e-2           # one bf16 rounding of the output (tests/test_kernels.py)
FLASH_F32_ATOL = 2e-5
RGLRU_ATOL = 1e-5
MAMBA_ATOL = 3e-4
BF16_ROUNDING = 2.0 ** -8         # one bf16 rounding to nearest moves y by at most 2^-8 |y|
LOGITS_ATOL = 1e-3               # f32 logits, card vs CPU: sums in other orders only
ARCHS = ("smollm-135m", "recurrentgemma-9b", "falcon-mamba-7b")
SFU_EX2_PER_CLOCK_SM = 16        # H100 (sm_90) MUFU ex2 results per clock per SM
H100_SMS = 132


def log(msg: str) -> None:
    print(msg, flush=True)


def median_ms(fn, reps: int = 7, inner: int = 20) -> float:
    """Median over ``reps`` of the mean time of ``inner`` back-to-back calls,
    by CUDA events."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return float(np.median(times))


def device_events(prof):
    """The device-side rows of a ``torch.profiler`` trace. A CPU op's row
    carries the device time of the kernels it launched and each kernel has
    a row of its own, so summing every row counts a torch op's kernels
    twice; the kernel rows alone count each launch once."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type != DeviceType.CPU and e.self_device_time_total > 0]


# every device_ms trace of n calls: how many, and those whose kernel rows
# were not n times one call's (taken again)
TRACES = {"taken": 0, "short": []}
# A trace brackets the calls it times with spin kernels (`torch.cuda._sleep`)
# after a pause, since a trace of bare calls loses some of their kernel rows
# (the `[profiler rows]` line counts them both ways); the spin kernels' rows
# are left out of the count.
SENTINELS = 4
SPIN_CYCLES = 2000
PAUSE_S = 0.05


def kernel_rows(prof):
    """(kernel rows, device us) of a ``torch.profiler`` trace, spin kernels
    left out."""
    rows = [e for e in device_events(prof) if "spin_kernel" not in e.key]
    return sum(e.count for e in rows), sum(e.self_device_time_total for e in rows)


def traced(fn, calls: int, sentinels: int = SENTINELS, pause_s: float = PAUSE_S):
    """A ``torch.profiler`` trace (the CUDA activity) of ``calls`` calls of
    ``fn`` between ``sentinels`` spin kernels before and after, begun
    ``pause_s`` after the card is idle and ended by a synchronize."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    time.sleep(pause_s)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(sentinels):
            torch.cuda._sleep(SPIN_CYCLES)
        for _ in range(calls):
            fn()
        for _ in range(sentinels):
            torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
    return prof


def trace_rows(fn, n: int = 20, traces: int = 5) -> dict:
    """Kernel rows of ``traces`` traces each of 1 and of ``n`` calls of
    ``fn`` (one kernel a call), and the mean kernel row's ms of the traces
    of ``n``: bare, between spin kernels, and between spin kernels after a
    pause. A trace that holds fewer rows than calls lost launches."""
    fn()
    torch.cuda.synchronize()
    out = {}
    for way, how in {"bare": (0, 0.0), "spin kernels": (SENTINELS, 0.0),
                     "spin kernels after a pause": (SENTINELS, PAUSE_S)}.items():
        one = [kernel_rows(traced(fn, 1, *how))[0] for _ in range(traces)]
        many = [kernel_rows(traced(fn, n, *how)) for _ in range(traces)]
        out[way] = {"1": one, str(n): [r for r, _ in many],
                    "row_ms": [us / r / 1e3 if r else None for r, us in many]}
    return out


def device_ms(fn, n: int = 20, tries: int = 3, launches: int = 0):
    """Device time per call of ``fn``: the summed device time of every kernel
    it launches, from a :func:`traced` trace of ``n`` calls. The trace must
    hold ``n`` times the kernel rows of one call (``launches`` where known,
    else counted in a traced single call): one that does not (or holds no
    device time) is taken again, up to ``tries`` times. Returns ``(ms,
    "profiler")``; where no trace was whole, ``launches`` times the mean
    kernel row of the last trace with ``"profiler, rows lost"`` if
    ``launches`` is known, else the CUDA-event wall time per call with
    ``"events"``."""
    def trace(calls: int):
        return kernel_rows(traced(fn, calls))

    fn()
    torch.cuda.synchronize()
    rows = us = 0
    for _ in range(tries):
        per_call = launches or trace(1)[0]
        rows, us = trace(n)
        TRACES["taken"] += 1
        if per_call > 0 and rows == n * per_call and us > 0:
            return us / n / 1e3, "profiler"
        TRACES["short"].append({"rows": rows, "want": n * per_call, "us": us})
    if launches and rows > 0:
        return us / rows * launches / 1e3, "profiler, rows lost"
    return median_ms(fn), "events"


def profiled_split(fn) -> dict:
    """One call of ``fn`` under ``torch.profiler``: its host-clock wall ms,
    the device ms of each kernel it launched (kernel rows only), and the
    device's idle share of the wall time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    kernels = {e.key: e.self_device_time_total / 1e3 for e in device_events(prof)}
    busy = sum(kernels.values())
    return {"wall_ms": wall_ms, "device_ms": busy, "idle_share": 1.0 - busy / wall_ms,
            "kernels_ms": kernels}


# ---------------------------------------------------------------------------
# Kernel inputs at the main path's shapes
# ---------------------------------------------------------------------------


def belief_inputs(rows_b: int, T: int, K: int, prefix: bool, seed: int, dev):
    """(responses, weights, empty) for belief_aggregate. ``prefix`` builds the
    router's layout: B queries x (T+1) prefixes of a T-wave history."""
    rng = np.random.default_rng(seed)
    if prefix:
        resp_bt = rng.integers(-1, K, (rows_b, T))
        hist = np.where(np.arange(T + 1)[None, :, None] > np.arange(T)[None, None, :],
                        resp_bt[:, None, :], -1).reshape(-1, T)
        w = np.repeat(rng.uniform(0.3, 3.0, (rows_b, 1, T)), T + 1, axis=1).reshape(-1, T)
        empty = np.repeat(rng.uniform(-3.0, -0.5, rows_b), T + 1)
    else:
        hist = rng.integers(-1, K, (rows_b, T))
        w = rng.uniform(0.3, 3.0, (rows_b, T))
        empty = rng.uniform(-3.0, -0.5, rows_b)
    put = lambda x, dt: torch.as_tensor(np.ascontiguousarray(x), device=dev).to(dt)
    return put(hist, torch.int32), put(w, torch.float32), put(empty, torch.float32)


def mc_inputs(G: int, T: int, L: int, K: int, C: int, seed: int, dev):
    """The planner's grouped estimator tables plus random candidate masks."""
    from repro_torch.core import prng
    from repro_torch.core.mc import GroupedXiEstimator

    rng = np.random.default_rng(seed)
    ps = rng.uniform(0.3, 0.95, (G, L))
    thetas = rng.integers(T // 2 + 1, T + 1, G)
    thetas[0] = T
    est = GroupedXiEstimator(prng.key(seed, dev), ps, K, thetas, device=dev)
    masks = (rng.random((G, C, L)) < 0.5).astype(np.float32)
    masks[:, :, 0] = 1.0
    return (est.responses, torch.as_tensor(masks, device=dev), est.log_weights,
            est.empty, est.valid, est.theta_f32)


def belief_bound(resp, K):
    rows, M = resp.shape
    nbytes = rows * M * 4 * 2 + rows * 4 + rows * K * 4 + rows * 4
    ops = int((resp >= 0).sum()) + rows * K * 2    # votes + display/argmax
    return nbytes, ops


def mc_bound(args, K):
    resp, masks, w, empty, valid, theta = args
    G, T, L = resp.shape
    C = masks.shape[1]
    nbytes = (resp.numel() + masks.numel() + w.numel() + empty.numel()
              + valid.numel() + theta.numel() + G * C) * 4
    n_valid = valid.sum(dim=1)                                  # (G,)
    n_mask = (masks > 0).sum(dim=2).to(torch.float64)           # (G, C)
    ops = float((n_valid[:, None].double() * (n_mask + 2 * K + 1)).sum())
    return nbytes, ops


def bound_ms(nbytes, ops, ops_per_s=F32_OPS_PER_S):
    """The least time for the work: bytes at the memory rate or operations
    at ``ops_per_s`` (the inputs' type), whichever is larger."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 3: kernels vs their plain versions on the card
# ---------------------------------------------------------------------------


def kernel_error(name: str, got, want, label: str) -> float:
    """Max abs error of a kernel's output against its plain version's on the
    same inputs; raises, printing the rows concerned, unless they are equal
    bit for bit: ``belief_aggregate`` (beliefs and predictions) and the two
    ``mc_correctness`` kernels add in their plain versions' order."""
    torch.cuda.synchronize()
    if name == "belief_aggregate":
        (bel, pred), (bel_p, pred_p) = got, want
        err = float((bel - bel_p).abs().max())
        bad = torch.nonzero(pred != pred_p)[:, 0].tolist()
        same = bool(torch.equal(bel, bel_p)) and not bad
        log(f"  {name} {label}: max_abs_err={err:.3g} pred_mismatch={len(bad)} bitwise={same}")
        if not same:
            raise AssertionError(
                f"{name} disagrees with its plain version at {label}: err {err}, "
                f"rows {bad[:10]} kernel {pred[bad[:10]].tolist()} plain {pred_p[bad[:10]].tolist()}"
            )
        return err
    err = float((got - want).abs().max())
    same = bool(torch.equal(got, want))
    log(f"  {name} {label}: max_abs_err={err:.3g} bitwise={same}")
    if not same:
        raise AssertionError(
            f"{name} differs from its plain version at {label}: "
            f"kernel {got.tolist()} plain {want.tolist()}"
        )
    return err


def single_cases():
    """(T, L, C, K, label) of phase 3's ``mc_correctness`` checks."""
    from repro_torch.core.mc import theta_for

    t_serve = theta_for(0.1, 0.01, 0.95, 12)
    return ((8000, 8, 8, 4, "Fig. 11"), (t_serve, 12, 12, 4, "serve defaults"),
            (t_serve, 12, 12, 77, "serve defaults"), (t_serve, 12, 12, 128, "serve defaults"),
            (300, 12, 1, 4, "one candidate, T < a block"), (1000, 8, 6, 17, "ragged last block"),
            (2500, 32, 7, 4, "L=32, the last register kernel"),
            (t_serve, 33, 8, 4, "wide kernel"), (t_serve, 64, 8, 4, "wide kernel"),
            (t_serve, 128, 8, 4, "wide kernel"), (t_serve, 40, 8, 1000, "wide kernel, by first voter"))


def single_inputs(T: int, L: int, C: int, K: int, seed: int, dev):
    """One pool's ``sample_pool_responses`` draws (through ``McXiEstimator``)
    plus random candidate masks: the arguments of ``mc_correctness``."""
    from repro_torch.core import McXiEstimator, prng

    rng = np.random.default_rng(seed)
    est = McXiEstimator(prng.key(seed, dev), rng.uniform(0.4, 0.95, L), K, T, device=dev)
    masks = (rng.random((C, L)) < 0.6).astype(np.float32)
    return est._responses, torch.as_tensor(masks, device=dev), est._w, est._empty


def single_bound(args, K):
    """(bytes, operations) of one ``mc_correctness`` call: draws, masks,
    weights and the empty belief read once, C values written; per draw and
    candidate one add per masked arm, the display, max and tie count."""
    resp, masks, w, _ = args
    T, L = resp.shape
    C = masks.shape[0]
    nbytes = (resp.numel() + masks.numel() + w.numel() + 1 + C) * 4
    ops = float(T * ((masks > 0).sum(dim=1).double() + 2 * K + 1).sum())
    return nbytes, ops


# (query rows B, M, K, prefix layout): belief_aggregate's phase-3 cases — the
# router's prefix-expanded layout at K=4 and 77 (64 (M + 1) rows), and M=40
# arms past 128 classes
BELIEF_CASES = ((130, 12, 77, False), (64, 12, 4, True), (64, 12, 77, True),
                (130, 40, 129, False), (130, 40, 200, False), (130, 40, 1000, False))
# (G, L, K) of the phase-3 mc_correctness_grouped checks at C=3, T=16384:
# the planner's shape, K=77 and 128, G=8, L=32 (the last register kernel),
# K=200 (folded bins), and the wide kernel at L=33 and 64
GROUPED_CASES = ((1, 12, 4), (1, 12, 77), (1, 12, 128), (8, 12, 4), (8, 12, 77), (8, 32, 4),
                 (8, 12, 200), (8, 33, 4), (8, 64, 4), (1, 40, 200))
# (G, T, L, K, C, label) of the phase-3 checks past the limits of earlier
# versions (1024 arms, 32767 classes, 65535 groups or candidates a launch),
# each bitwise for both mc kernels (the single one on group 0)
LIFTED_CASES = ((2, 300, 1100, 4, 3, "int16 staging, one warp"),
                (2, 300, 12, 40000, 3, "register kernel, folded bins"),
                (2, 300, 64, 40000, 3, "int32 staging"),
                (1, 300, 1100, 40000, 3, "no staging"),
                (2, 300, 2100, 4, 3, "no staging"))
# (G, T, L, K, C): one launch a chunk of 65535 groups, or of 65535 candidates
CHUNKED_CASES = ((65537, 8, 4, 3, 2), (2, 8, 4, 3, 65537))


def lifted_inputs(G: int, T: int, L: int, K: int, C: int, dev):
    """Grouped ``mc_correctness`` arguments at any size: responses uniform
    over [-1, K) with half the arms on classes -1..2 (so class 0 draws
    votes and ties), random masks with the last candidate empty, the last
    seventh of the draws invalid."""
    rng = np.random.default_rng(L + K + G + C)
    resp = rng.integers(-1, K, (G, T, L)).astype(np.int32)
    resp[:, :, : L // 2] = rng.integers(-1, 3, (G, T, L // 2))
    masks = (rng.random((G, C, L)) < 0.6).astype(np.float32)
    masks[:, -1] = 0.0
    valid = np.ones((G, T), np.float32)
    valid[:, T - T // 7:] = 0.0
    arrays = (resp, masks, rng.uniform(0.3, 3.0, (G, L)).astype(np.float32),
              rng.uniform(-3.0, -0.5, G).astype(np.float32), valid,
              valid.sum(axis=1).astype(np.float32))
    return tuple(torch.as_tensor(a, device=dev) for a in arrays)


def single_of(args):
    """The single-pool kernel's arguments: group 0 of grouped ones."""
    resp, masks, w, empty = args[:4]
    return resp[0], masks[0], w[0], empty[:1]


def check_lifted(dev, errs: dict) -> list:
    """Both mc kernels past the limits of earlier versions, each bitwise
    its plain version; returns the timed rows of the lifted cases (device
    ms of one call at the checked shape, beside its bound)."""
    from repro_torch.kernels import ops, ref

    rows = []
    for G, T, L, K, C, label in LIFTED_CASES:
        args = lifted_inputs(G, T, L, K, C, dev)
        one = single_of(args)
        shape = f"G={G} T={T} L={L} K={K} C={C}"
        errs["mc_correctness_grouped"] = max(errs["mc_correctness_grouped"], kernel_error(
            "mc_correctness_grouped", ops.mc_correctness_grouped(*args, K),
            ref.mc_correctness_grouped_ref(*args, K), f"{label}: {shape}"))
        errs["mc_correctness"] = max(errs["mc_correctness"], kernel_error(
            "mc_correctness", ops.mc_correctness(*one, K), ref.mc_correctness_ref(*one, K),
            f"{label}: T={T} L={L} C={C} K={K}"))
        for name, fn, a, bound in (("mc_correctness_grouped", ops.mc_correctness_grouped, args,
                                    mc_bound(args, K)),
                                   ("mc_correctness", ops.mc_correctness, one,
                                    single_bound(one, K))):
            b_ms, b_by = bound_ms(*bound)
            ms, ms_source = device_ms(lambda: fn(*a, K), n=5, launches=1)
            rows.append({"name": name, "case": label, "shape": shape, "ms": ms,
                         "ms_source": ms_source, "bound_ms": b_ms, "bound_by": b_by})
        del args, one
        torch.cuda.empty_cache()
    for G, T, L, K, C in CHUNKED_CASES:
        args = lifted_inputs(G, T, L, K, C, dev)
        shape = f"G={G} T={T} L={L} K={K} C={C}"
        errs["mc_correctness_grouped"] = max(errs["mc_correctness_grouped"], kernel_error(
            "mc_correctness_grouped", ops.mc_correctness_grouped(*args, K),
            ref.mc_correctness_grouped_ref(*args, K), f"chunked launches: {shape}"))
        if C > 65535:
            one = tuple(t.contiguous() for t in single_of(args))
            errs["mc_correctness"] = max(errs["mc_correctness"], kernel_error(
                "mc_correctness", ops.mc_correctness(*one, K), ref.mc_correctness_ref(*one, K),
                f"chunked launches: T={T} L={L} C={C} K={K}"))
    return rows


def check_kernels(dev) -> dict:
    from repro_torch.kernels import ops, ref

    errs = {"belief_aggregate": 0.0, "mc_correctness_grouped": 0.0, "mc_correctness": 0.0}
    for rows_b, T, K, prefix in BELIEF_CASES:
        args = belief_inputs(rows_b, T, K, prefix, seed=rows_b + K, dev=dev)
        err = kernel_error("belief_aggregate", ops.belief_aggregate(*args, K),
                           ref.belief_aggregate_ref(*args, K),
                           f"rows={args[0].shape[0]} M={T} K={K}")
        errs["belief_aggregate"] = max(errs["belief_aggregate"], err)
    for G, L, K in GROUPED_CASES:
        args = mc_inputs(G, 16384, L, K, 3, seed=G * 100 + K + L, dev=dev)
        err = kernel_error("mc_correctness_grouped", ops.mc_correctness_grouped(*args, K),
                           ref.mc_correctness_grouped_ref(*args, K),
                           f"G={G} C=3 T=16384 L={L} K={K}")
        errs["mc_correctness_grouped"] = max(errs["mc_correctness_grouped"], err)
    for T, L, C, K, label in single_cases():
        args = single_inputs(T, L, C, K, seed=T + C + K, dev=dev)
        err = kernel_error("mc_correctness", ops.mc_correctness(*args, K),
                           ref.mc_correctness_ref(*args, K), f"{label}: T={T} L={L} C={C} K={K}")
        errs["mc_correctness"] = max(errs["mc_correctness"], err)
    single = single_inputs(8471, 12, 12, 4, seed=3, dev=dev)
    grouped = mc_inputs(1, 16384, 12, 4, 3, seed=4, dev=dev)
    belief = belief_inputs(64, 10, 4, True, seed=5, dev=dev)
    one_launch("mc_correctness", lambda: ops.mc_correctness(*single, 4))
    one_launch("mc_correctness_grouped", lambda: ops.mc_correctness_grouped(*grouped, 4))
    one_launch("belief_aggregate", lambda: ops.belief_aggregate(*belief, 4))
    errs["lifted"] = check_lifted(dev, errs)
    return errs


def one_launch(name: str, fn) -> None:
    """One call of ``fn`` (inputs on the card, kernel built) under
    ``torch.profiler``: raises unless the trace shows exactly one kernel
    launch and the call allocates nothing beyond its outputs (each one
    block of the caching allocator, a multiple of 512 bytes)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    outs = out if isinstance(out, tuple) else (out,)
    out_bytes = [t.numel() * t.element_size() for t in outs]
    allowed = sum(-(-b // 512) * 512 for b in out_bytes)
    rows = [(e.key, e.count) for e in device_events(prof)]
    log(f"  {name}: one call = kernel rows {rows}, {grown} bytes allocated "
        f"(outputs {out_bytes} bytes)")
    if len(rows) != 1 or rows[0][1] != 1 or grown > allowed:
        raise AssertionError(f"{name}: one call must be one launch and its output allocations, "
                             f"got kernel rows {rows} and {grown} bytes")


# ---------------------------------------------------------------------------
# Phases 4-5: route on the card, hold it against the CPU
# ---------------------------------------------------------------------------


def serve_state(K: int, seed: int = 0, num_arms: int = 12):
    """The serve defaults: a 12-arm oracle pool over 6 clusters, calibrated
    from 2000 historical responses (``num_arms`` arms where given)."""
    from repro_torch import convert
    from repro_torch.core.clustering import kmeans
    from repro_torch.data.synth import OracleWorkload

    wl = OracleWorkload(num_classes=K, num_clusters=6, num_arms=num_arms, seed=seed)
    table, emb, _ = wl.response_table(2000, seed=1)
    assign, _ = kmeans(emb, 6, seed=0)
    arms = [{"name": f"llm-{i}", "arm_index": i, "seed": 9, "metered": False}
            for i in range(num_arms)]
    return wl, convert.workload_state(wl), {"table": table, "emb": emb, "assign": assign}, arms


def batches(wl, n: int, seed: int):
    """``n`` (queries, embeddings, budgets) batches of 64: the first uniform
    at 1e-4 USD, the rest with per-query budgets from {3e-5, 1e-4, 3e-4}."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        cid, emb, lab = wl.sample_queries(64, rng)
        budget = 1e-4 if i == 0 else rng.choice([3e-5, 1e-4, 3e-4], size=64)
        out.append((np.stack([cid, lab], 1), emb, budget))
    return out


def route_all(router, work):
    """Route every batch on the device plane, then the last one again on the
    host reference plane; returns the RouteResults."""
    res = [router.route_batch(q, e, b) for q, e, b in work]
    q, e, b = work[-1]
    res.append(router.route_batch_reference(q, e, b))
    return res


def compare_plans(gpu, cpu) -> None:
    """The two routers' plans, bitwise: sets, xi, cost, p* and gamma."""
    if gpu.selector._cache.keys() != cpu.selector._cache.keys():
        raise AssertionError("the two devices planned different (p, K, budget) pairs")
    for key, s in gpu.selector._cache.items():
        c = cpu.selector._cache[key]
        same_sets = (np.array_equal(s.chosen, c.chosen) and s.l_star == c.l_star
                     and (s.s1 is None) == (c.s1 is None)
                     and (s.s1 is None or (np.array_equal(s.s1, c.s1) and np.array_equal(s.s2, c.s2))))
        xi = np.array([s.xi_est, s.xi_s1, s.xi_s2])
        xi_c = np.array([c.xi_est, c.xi_s1, c.xi_s2])
        ok = (same_sets and np.array_equal(xi, xi_c) and s.cost == c.cost
              and s.p_star == c.p_star and s.gamma_s2 == c.gamma_s2)
        if not ok:
            raise AssertionError(
                f"plan mismatch at budget {key[2]}: card chosen={s.chosen} s1={s.s1} s2={s.s2} "
                f"xi={xi.tolist()} / cpu chosen={c.chosen} s1={c.s1} s2={c.s2} xi={xi_c.tolist()}"
            )


def compare_routes(gpu_res, cpu_res) -> None:
    """The two routers' results, bitwise."""
    for i, (g, c) in enumerate(zip(gpu_res, cpu_res)):
        for field in ("predictions", "schedule", "invoked", "responses", "costs", "planned_costs"):
            a, b = getattr(g, field), getattr(c, field)
            if not np.array_equal(a, b):
                rows = np.flatnonzero((np.asarray(a) != np.asarray(b)).reshape(len(a), -1).any(1))
                raise AssertionError(
                    f"batch {i}: {field} differ at rows {rows[:10].tolist()}: "
                    f"card {np.asarray(a)[rows[:3]].tolist()} cpu {np.asarray(b)[rows[:3]].tolist()}"
                )
        err = float(np.abs(g.beliefs - c.beliefs).max())
        if not np.array_equal(g.beliefs, c.beliefs):
            rows = np.flatnonzero((g.beliefs != c.beliefs).any(1))
            raise AssertionError(
                f"batch {i}: beliefs differ (max {err:.3g}) at rows {rows[:10].tolist()}"
            )
        if not np.all(np.isfinite(g.beliefs)):
            raise AssertionError(f"batch {i}: non-finite beliefs")


def route_phase(dev) -> dict:
    from repro_torch import convert

    wl, state, history, arms = serve_state(K=4)
    work = batches(wl, 3, seed=42)
    shapes = {}
    for use_kernel in (False, True):
        results = {}
        routers = {}
        for label, where in (("card", dev), ("cpu", torch.device("cpu"))):
            t0 = time.perf_counter()
            router = convert.router_from_state(
                state, history, arms, 4, eps=0.1, delta=0.01, use_kernel=use_kernel, device=where,
            )
            results[label] = route_all(router, work)
            torch.cuda.synchronize()
            routers[label] = router
            log(f"  use_kernel={use_kernel} {label}: 4 routes of 64 in "
                f"{time.perf_counter() - t0:.2f} s")
        compare_plans(routers["card"], routers["cpu"])
        compare_routes(results["card"], results["cpu"])
        log(f"  use_kernel={use_kernel}: card == cpu (bitwise), "
            f"{len(routers['card'].selector._cache)} plans, "
            f"accuracy {np.mean([np.mean(r.predictions == w[0][:, 1]) for r, w in zip(results['card'], work + work[-1:])]):.3f}")
        if use_kernel:
            # the shapes the kernel plane gave each kernel
            card = routers["card"]
            T_main = max(r.schedule.shape[1] for r in results["card"][:-1])
            thetas = [card.selector.theta(card.estimator.clusters[c].p_hat, b)
                      for c in card.estimator.clusters for b in (3e-5, 1e-4, 3e-4)]
            shapes = {"belief_T": T_main, "mc_theta": max(thetas)}
    return shapes


def k77_phase(dev) -> None:
    from repro_torch import convert

    wl, state, history, arms = serve_state(K=77, seed=1)
    router = convert.router_from_state(state, history, arms, 77, eps=0.1, delta=0.01,
                                       use_kernel=True, device=dev)
    (q, e, b), = batches(wl, 2, seed=7)[1:]
    res = router.route_batch(q, e, b)
    torch.cuda.synchronize()
    ok = (res.beliefs.shape == (64, 77) and np.all(np.isfinite(res.beliefs))
          and np.all((res.predictions >= 0) & (res.predictions < 77))
          and np.all(res.costs <= np.asarray(b) + 1e-15))
    if not ok:
        raise AssertionError("K=77 route gave malformed output")
    log(f"  K=77: 64 queries routed, accuracy {np.mean(res.predictions == q[:, 1]):.3f}, "
        f"mean cost {res.costs.mean():.3e}, {len(router.selector._cache)} plans")


def route_times(dev) -> dict:
    """Host-clock time of one 64-query route on the card, each ending in a
    synchronize: cold (its plans are built in the call) and warm (plans
    cached; median of 5), for a uniform and a mixed-budget batch on both
    belief backends."""
    from repro_torch import convert

    wl, state, history, arms = serve_state(K=4)
    out = {}
    for use_kernel in (False, True):
        router = convert.router_from_state(state, history, arms, 4, eps=0.1, delta=0.01,
                                           use_kernel=use_kernel, device=dev)
        for label, (q, e, b) in zip(("uniform", "mixed"), batches(wl, 2, seed=43)):
            times = []
            for _ in range(6):
                t0 = time.perf_counter()
                router.route_batch(q, e, b)
                torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
            out[f"{label}_{'kernel' if use_kernel else 'f64'}"] = {
                "cold_ms": times[0], "warm_ms": float(np.median(times[1:])),
            }
    return out


# ---------------------------------------------------------------------------
# Phases 7-10: the LM arms — kernels, models card vs CPU, the LM-arm route
# ---------------------------------------------------------------------------


def _randn(shape, gen, dev, scale=1.0):
    return torch.randn(shape, generator=gen, device=dev).mul_(scale)


def flash_inputs(B, S, T, H, G, hd, dtype, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return tuple(_randn(s, gen, dev).to(dtype) for s in ((B, S, H, hd), (B, T, G, hd), (B, T, G, hd)))


def rglru_inputs(B, S, D, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (_randn((B, S, D), gen, dev, 0.5).abs_().neg_(), _randn((B, S, D), gen, dev),
            _randn((B, D), gen, dev))


def mamba_inputs(B, S, Din, N, seed, dev):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (_randn((B, S, Din), gen, dev), _randn((B, S, Din), gen, dev, 0.3).abs_().add_(0.01),
            _randn((Din, N), gen, dev, 0.5).abs_().add_(0.5).neg_(), _randn((B, S, N), gen, dev),
            _randn((B, S, N), gen, dev), _randn((Din,), gen, dev), _randn((B, Din, N), gen, dev))


def mamba_path_inputs(B, S, Din, N, R, seed, dev):
    """The SSM block's own scan arguments: bf16 x, f32 dt (the block's
    softplus adds an f32 bias), B and C as strided views of one bf16
    (B, S, R + 2N) projection, f32 A and D, no initial state."""
    x, dt, A, _, _, D, _ = mamba_inputs(B, S, Din, N, seed, dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    _, Bm, Cm = _randn((B, S, R + 2 * N), gen, dev).to(torch.bfloat16).split([R, N, N], dim=-1)
    return x.to(torch.bfloat16), dt, A, Bm, Cm, D, None


# (label, B, S, T, H, G, hd, window, dtype, atol): the two path shapes in
# bf16, bf16 at ragged lengths, a small window, hd 16 / 32 / 128 and
# query / kv head ratios 1, 3 and 16, then f32 with and without windows,
# at hd 64 and 256
FLASH_CASES = (
    ("smollm path", 64, 127, 127, 9, 3, 64, 0, torch.bfloat16, FLASH_BF16_ATOL),
    ("recurrentgemma path", 64, 127, 127, 16, 1, 256, 2048, torch.bfloat16, FLASH_BF16_ATOL),
    ("ragged S < T", 2, 37, 45, 4, 2, 64, 0, torch.bfloat16, FLASH_BF16_ATOL),
    ("window 5", 3, 37, 37, 6, 2, 16, 5, torch.bfloat16, FLASH_BF16_ATOL),
    ("hd 32, ratio 1", 2, 70, 70, 4, 4, 32, 0, torch.bfloat16, FLASH_BF16_ATOL),
    ("hd 128, ratio 3", 1, 129, 129, 6, 2, 128, 0, torch.bfloat16, FLASH_BF16_ATOL),
    ("ratio 16", 2, 127, 127, 16, 1, 64, 0, torch.bfloat16, FLASH_BF16_ATOL),
    ("f32", 2, 127, 127, 4, 2, 64, 0, torch.float32, FLASH_F32_ATOL),
    ("f32", 2, 127, 127, 4, 2, 64, 48, torch.float32, FLASH_F32_ATOL),
    ("f32", 1, 300, 300, 16, 1, 256, 64, torch.float32, FLASH_F32_ATOL),
)
RGLRU_CASES = ((64, 127, 4096), (3, 37, 200))
MAMBA_CASES = ((64, 127, 8192, 16), (2, 37, 96, 8))
MAMBA_PATH = (64, 127, 8192, 16, 256)   # falcon-mamba-7b: B, S, d_inner, N, dt_rank


def output_error(name: str, got, want, atol: float, label: str) -> float:
    """Max abs error over a kernel's outputs against its plain version's;
    raises past ``atol`` or on a non-finite output."""
    torch.cuda.synchronize()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max(float((g.float() - w.float()).abs().max()) for g, w in zip(got, want))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    log(f"  {name} {label}: max_abs_err={err:.3g}")
    if not (finite and err <= atol):
        raise AssertionError(f"{name} disagrees with its plain version at {label}: "
                             f"err {err} (atol {atol}), finite={finite}")
    return err


def check_model_kernels(dev) -> dict:
    from repro_torch.kernels import ops, ref

    errs = {"flash_attention": 0.0, "rglru_scan": 0.0, "mamba_scan": 0.0}
    for i, (label, B, S, T, H, G, hd, w, dtype, atol) in enumerate(FLASH_CASES):
        args = flash_inputs(B, S, T, H, G, hd, dtype, seed=10 + i, dev=dev)
        plain = ref.flash_attention_ref(*(a.float() for a in args), window=w)   # f32 plain
        err = output_error("flash_attention", ops.flash_attention(*args, window=w), plain, atol,
                           f"{label} B={B} S={S} T={T} H={H} G={G} hd={hd} window={w} "
                           f"{str(dtype)[6:]}")
        errs["flash_attention"] = max(errs["flash_attention"], err)
    for i, (B, S, D) in enumerate(RGLRU_CASES):
        args = rglru_inputs(B, S, D, seed=20 + i, dev=dev)
        err = output_error("rglru_scan", ops.rglru_scan(*args), ref.rglru_scan_ref(*args),
                           RGLRU_ATOL, f"B={B} S={S} D={D}")
        errs["rglru_scan"] = max(errs["rglru_scan"], err)
    B, S, Din, N, R = MAMBA_PATH
    args = mamba_path_inputs(B, S, Din, N, R, seed=29, dev=dev)
    y, h_last = ops.mamba_scan(*args)
    # the plain version on an f32 copy of x gives y unrounded: the kernel's
    # bf16 y is then one rounding to nearest away, within 3e-4 + 2^-8 |y|
    wy, wh = ref.mamba_scan_ref(args[0].float(), *args[1:])
    label = f"path case B={B} S={S} Din={Din} N={N} bf16 x/B/C, strided B/C, f32 dt, no h0"
    err = output_error("mamba_scan", h_last, wh, MAMBA_ATOL, f"{label}: h_last")
    y_err = (y.float() - wy).abs()
    y_ok = bool((y_err <= MAMBA_ATOL + BF16_ROUNDING * wy.abs()).all())
    log(f"  mamba_scan {label}: y max_abs_err={float(y_err.max()):.3g} "
        f"(y {y.dtype} against the unrounded f32 y, within 3e-4 + 2^-8 |y|: {y_ok})")
    if not (y_ok and y.dtype == torch.bfloat16 and bool(torch.isfinite(y).all())):
        raise AssertionError(f"mamba_scan disagrees with its plain version at {label}: "
                             f"y err {float(y_err.max())}")
    errs["mamba_scan"] = max(errs["mamba_scan"], err, float(y_err.max()))
    for i, (B, S, Din, N) in enumerate(MAMBA_CASES):
        args = mamba_inputs(B, S, Din, N, seed=30 + i, dev=dev)
        err = output_error("mamba_scan", ops.mamba_scan(*args), ref.mamba_scan_ref(*args),
                           MAMBA_ATOL, f"f32 B={B} S={S} Din={Din} N={N} with h0")
        errs["mamba_scan"] = max(errs["mamba_scan"], err)
    return errs


def unit_config(arch: str):
    """The published config in f32, cut to one pattern unit of depth (width
    untouched) so that its CPU forward takes seconds."""
    from repro_torch.configs import get_config

    cfg = get_config(arch)
    return dataclasses.replace(cfg, num_layers=len(cfg.block_pattern), dtype="float32")


def model_phase(dev) -> dict:
    """Each family's one-unit f32 model: the same weights forward on the
    card (the kernels) and on the CPU (their plain versions)."""
    from repro_torch.models import LM

    errs = {}
    for i, arch in enumerate(ARCHS):
        cfg = unit_config(arch)
        t0 = time.perf_counter()
        model = LM(cfg, device=dev, seed=7 + i)
        tokens = torch.as_tensor(np.random.default_rng(i).integers(0, cfg.vocab_size, (2, 127)))
        with torch.inference_mode():
            got = model(tokens.to(dev)).cpu()
            model.to("cpu")                          # the same weights, on the CPU
            want = model(tokens)
        err = float((got - want).abs().max())
        ok = bool(torch.isfinite(got).all()) and got.shape == (2, 127, want.shape[-1])
        log(f"  {arch} {cfg.layer_types} f32: logits {tuple(got.shape)} card vs cpu "
            f"max_abs_err={err:.3g} (|logit| <= {float(want.abs().max()):.3g}) "
            f"in {time.perf_counter() - t0:.1f} s")
        if not (ok and err <= LOGITS_ATOL):
            raise AssertionError(f"{arch}: card logits differ from the CPU's by {err} "
                                 f"(atol {LOGITS_ATOL}), finite/shape ok={ok}")
        errs[arch] = err
        del model
    torch.cuda.empty_cache()
    return errs


def token_embed(tokens, vocab: int) -> np.ndarray:
    """The bincount query embedding of ``examples/train_and_serve.py``."""
    return np.stack([np.bincount(t, minlength=vocab) for t in tokens]).astype(float)


def lm_route_phase(dev) -> dict:
    """Three full-width bf16 arms on the card, calibrated on a 256-query
    history and routed over two 64-query batches with ``use_kernel=True``.
    The launch counters are zeroed before and read after calibration and the
    two routes; the checks that follow run after the read.

    Arms with random weights answer at chance (1/K), where SurGreedy's plan
    stops before its first wave and no arm would run inside a route. So the
    calibration table scores each arm against the arms' own answers in turn
    (history query i takes arm i mod 3's answer): every arm calibrates above
    chance and the routes invoke arms wave by wave. Accuracy against the
    task's labels is printed beside it (near 1/K: a smoke, not a quality
    check)."""
    from repro_torch.configs import get_config
    from repro_torch.core.estimation import SuccessProbEstimator
    from repro_torch.data import make_token_task
    from repro_torch.kernels import ops
    from repro_torch.models import LM
    from repro_torch.serving import LMArm, PoolEngine, ThriftRouter

    K, SEQ, VOCAB, N_HIST = 4, 128, 512, 256
    t0 = time.perf_counter()
    cls_ids = make_token_task(K, SEQ, VOCAB, n=1, seed=0)["class_token_ids"]
    arms = [LMArm(arch, LM(get_config(arch), device=dev, seed=100 + i), cls_ids,
                  tokens_per_query=SEQ) for i, arch in enumerate(ARCHS)]
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    log(f"  init: {sum(p.numel() for a in arms for p in a.model.parameters()) / 1e9:.2f} B "
        f"bf16 params on the card in {init_s:.1f} s; prices "
        + ", ".join(f"{a.name} {a.cost:.3e}" for a in arms))
    hist = make_token_task(K, SEQ, VOCAB, n=N_HIST, seed=1)
    test = make_token_task(K, SEQ, VOCAB, n=128, seed=2)
    emb = token_embed(hist["tokens"], VOCAB)
    assign = np.zeros(N_HIST, np.int64)
    costs = np.array([a.cost for a in arms])
    rng = np.random.default_rng(5)
    work = [
        (test["tokens"][:64], token_embed(test["tokens"][:64], VOCAB), float(costs.sum())),
        (test["tokens"][64:], token_embed(test["tokens"][64:], VOCAB),
         rng.choice(np.linspace(costs.min(), costs.sum(), 4), size=64)),
    ]

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    answers = np.zeros((N_HIST, len(arms)), np.int64)
    fwd_ms = {}
    for a, arm in enumerate(arms):
        times = []
        for lo in range(0, N_HIST, 64):
            t1 = time.perf_counter()
            answers[lo:lo + 64, a] = arm.classify_batch(hist["tokens"][lo:lo + 64])  # ends in a sync
            times.append((time.perf_counter() - t1) * 1e3)
        fwd_ms[arm.name] = float(np.median(times[1:]))
    rows = np.arange(N_HIST)
    table = (answers == answers[rows, rows % len(arms)][:, None]).astype(np.float64)
    router = ThriftRouter(PoolEngine(arms), SuccessProbEstimator(table, emb, assign), K,
                          use_kernel=True, device=dev)
    results = [router.route_batch(q, e, b) for q, e, b in work]
    torch.cuda.synchronize()
    launches = {
        "flash_attention": ops.flash_attention.launches, "rglru_scan": ops.rglru_scan.launches,
        "mamba_scan": ops.mamba_scan.launches, "belief_aggregate": ops.belief_aggregate.launches,
        "mc_correctness_grouped": ops.mc_correctness_grouped.launches,
    }
    main_s = time.perf_counter() - t0
    log(f"  calibrate (256 queries x 3 arms) + 2 routes of 64 in {main_s:.1f} s; "
        f"launches {launches}")
    for name in ("flash_attention", "rglru_scan", "mamba_scan", "belief_aggregate"):
        if launches[name] <= 0:
            raise AssertionError(f"kernel {name} was never launched on the LM-arm route")
    for a, arm in enumerate(arms):
        log(f"  {arm.name}: history accuracy {np.mean(answers[:, a] == hist['labels']):.3f} "
            f"(K={K}, random weights), calibrated p {table[:, a].mean():.3f}, "
            f"forward of 64 queries {fwd_ms[arm.name]:.1f} ms (median of 3)")
    if sum(int(r.arm_query_counts.sum()) for r in results) == 0:
        raise AssertionError("the LM-arm routes invoked no arm")
    for i, ((q, e, b), res) in enumerate(zip(work, results)):
        labels = test["labels"][64 * i:64 * (i + 1)]
        if not (np.all(res.costs <= np.asarray(b) + 1e-15)
                and np.all((res.predictions >= 0) & (res.predictions < K))
                and np.all(np.isfinite(res.beliefs))):
            raise AssertionError(f"LM batch {i}: cost over budget or malformed output")
        log(f"  batch {i} ({'uniform' if i == 0 else 'mixed'} budget): accuracy "
            f"{np.mean(res.predictions == labels):.3f}, served per arm "
            f"{res.arm_query_counts.tolist()}, mean cost {res.costs.mean():.3e}, waves {res.waves}")
    # the same batches again on the card, and on a router that plans on the CPU
    cpu_router = ThriftRouter(PoolEngine(arms), SuccessProbEstimator(table, emb, assign), K,
                              use_kernel=True, device="cpu")
    for i, ((q, e, b), res) in enumerate(zip(work, results)):
        again = router.route_batch(q, e, b)
        cpu_router.route_batch(q, e, b)
        if not (np.array_equal(again.predictions, res.predictions)
                and np.array_equal(again.costs, res.costs)):
            raise AssertionError(f"LM batch {i}: routing it twice gave different answers")
    compare_plans(router, cpu_router)
    log(f"  routes repeat exactly; {len(router.selector._cache)} plans equal the CPU planner's "
        f"bitwise")
    sched_launches = lm_scheduler_check(router, work, results)
    lm_fault_check(router, arms, work[1])
    breakdown = {arm.name: forward_breakdown(arm, work[0][0]) for arm in arms}
    for name, b in breakdown.items():
        log(f"  {name} forward breakdown: " + ", ".join(f"{k} {v:.3f}" for k, v in b.items()))
    del arms, router, cpu_router
    torch.cuda.empty_cache()
    return {"launches": launches, "forward_ms": fwd_ms, "init_s": init_s, "main_s": main_s,
            "breakdown": breakdown, "scheduler_launches": sched_launches}


def admission_groups(budgets, n: int):
    """Row groups of one admission of ``n`` rows as the scheduler splits it:
    one group per budget, in first-occurrence order, FIFO inside."""
    budgets = np.broadcast_to(np.asarray(budgets, np.float64), (n,))
    if (budgets == budgets[0]).all():
        return [np.arange(n)]
    _, first = np.unique(budgets, return_index=True)
    return [np.flatnonzero(budgets == budgets[i]) for i in np.sort(first)]


def lm_scheduler_check(router, work, results) -> dict:
    """The LM-arm route's two batches through a ``BatchScheduler``
    (``max_batch`` 64, ``max_inflight`` 2, no faults, no labels): with
    nothing to fold, each admission group routes as the router routes that
    group alone, so predictions, costs and stop waves equal the router's
    own routes of the same groups (the uniform batch: its route above).
    Returns the model kernels' launches of the scheduler's run."""
    from repro_torch.kernels import ops
    from repro_torch.serving import BatchScheduler

    ops.reset_launch_counts()
    sched = BatchScheduler(router, max_batch=64, max_inflight=2, max_wait_s=0.0)
    blocks = [sched.submit_many(q, e, b) for q, e, b in work]
    sched.drain()
    torch.cuda.synchronize()
    launches = {name: getattr(ops, name).launches for name in
                ("flash_attention", "rglru_scan", "mamba_scan", "belief_aggregate")}
    for i, ((q, e, b), blk) in enumerate(zip(work, blocks)):
        want = np.zeros((3, q.shape[0]))
        for rows in admission_groups(b, q.shape[0]):
            res = (results[i] if rows.size == q.shape[0]
                   else router.route_batch(q[rows], e[rows], np.asarray(b)[rows]))
            want[:, rows] = res.predictions, res.costs, res.stop_waves
        got = np.stack([blk.predictions, blk.costs, blk.stop_waves])
        if not np.array_equal(got, want):
            bad = np.flatnonzero((got != want).any(axis=0))
            raise AssertionError(f"LM batch {i} through the scheduler differs from the router's "
                                 f"routes at rows {bad[:10].tolist()}")
    st = sched.stats
    log(f"  scheduler (max_batch 64, max_inflight 2): both batches equal the router's routes of "
        f"their admission groups; groups {st['batches']}, planes jit={st['spec_jit']} "
        f"ref={st['spec_reference']}, inflight peak {st['inflight_peak']}; launches {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was never launched through the scheduler")
    return launches


def lm_fault_check(router, arms, batch) -> None:
    """The mixed-budget batch (whose plans lead with smollm on some rows)
    with faults on smollm (timeout 0.3, error 0.2): failed cells are never
    invoked, so smollm classifies exactly the scheduled, unfailed cells of
    its arm (its forwards counted row by row); the failures the wavefront
    attempted are smollm's alone, their slots re-routed in-wave, and the
    outputs stay well formed."""
    from repro_torch.distributed.fault import FAULT_ERROR, FAULT_TIMEOUT, FaultPolicy

    q, e, b = batch
    policy = FaultPolicy(len(arms), router.num_classes, seed=7).set_arm(0, timeout=0.3, error=0.2)
    seen = []
    plain = arms[0].classify_batch
    arms[0].classify_batch = lambda tokens: (seen.append(len(tokens)), plain(tokens))[1]
    router.engine.fault_policy = policy
    try:
        res = router.route_batch(q, e, b)
        torch.cuda.synchronize()
    finally:
        router.engine.fault_policy = None
        del arms[0].classify_batch
    sched_T = res.fault_schedule.T
    codes = policy.grid_codes(sched_T)
    failed = (codes == FAULT_TIMEOUT) | (codes == FAULT_ERROR)
    want = int(((sched_T == 0) & ~failed).sum())
    if sum(seen) != want or failed.sum() == 0 or res.arm_fault_counts[0] == 0:
        raise AssertionError(f"smollm classified {sum(seen)} rows under faults, want {want} "
                             f"({int(failed.sum())} cells failed)")
    ok = (np.all((res.predictions >= 0) & (res.predictions < router.num_classes))
          and np.all(res.costs <= np.asarray(b) + 1e-15)
          and set(np.flatnonzero(res.arm_fault_counts).tolist()) <= {0}
          and np.all(res.responses[res.invoked] >= 0))
    if not ok:
        raise AssertionError("the faulted LM batch gave malformed output")
    log(f"  faults on smollm: {int(failed.sum())} of {int((sched_T == 0).sum())} smollm cells "
        f"failed, smollm classified {sum(seen)} rows in {len(seen)} forwards (= the unfailed "
        f"cells); attempted failures {res.arm_fault_counts.tolist()}, served per arm "
        f"{res.arm_query_counts.tolist()}")


MODEL_KERNELS = ("flash_attention", "rglru_scan", "mamba_scan")
GEMM_MARKS = ("gemm", "cutlass", "nvjet", "xmma", "cublas")


def forward_breakdown(arm, tokens) -> dict:
    """Where one 64-query forward of ``arm`` spends its time: host-clock wall
    ms of a ``classify_batch`` (which ends in copying its answers to the
    host) under ``torch.profiler``, the device time of its kernels split
    into the model kernels, cuBLAS matmuls and everything else, and the
    device's idle share of the wall time."""
    prof = profiled_split(lambda: arm.classify_batch(tokens))
    parts = dict.fromkeys([*MODEL_KERNELS, "matmul", "other"], 0.0)
    for key, ms in prof["kernels_ms"].items():
        cat = next((k for k in MODEL_KERNELS if f"{k}_kernel" in key), None)
        if cat is None:
            cat = "matmul" if any(m in key.lower() for m in GEMM_MARKS) else "other"
        parts[cat] += ms
    return {**{k: prof[k] for k in ("wall_ms", "device_ms", "idle_share")},
            **{f"{k}_ms": v for k, v in parts.items()}}


def flash_bound(q, k, window: int):
    """(bytes, operations) of one causal attention launch: q, k, v read once
    and out written once; 4 hd flops per visible (query, key) pair."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    i = np.arange(S)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros(S, np.int64)
    pairs = int((np.minimum(i + 1, T) - lo).clip(min=0).sum())
    nbytes = (2 * q.numel() + 2 * k.numel()) * q.element_size()
    return nbytes, 4.0 * hd * pairs * B * H


def sdpa_ms(q, k, v):
    """The yardstick: one ``scaled_dot_product_attention`` call on the same
    tensors (causal, GQA); timed here only, never called by the port."""
    import torch.nn.functional as F

    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    return device_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                                            enable_gqa=True))[0]


# The earlier kernels' device ms at the same shapes, as PERF.md section 6
# records them (NVIDIA H100 80GB HBM3, 700.00 W): flash v2 (f32 products on
# the CUDA cores) per path shape, mamba_scan v1 (accurate expf, f32 in and
# out, the casts outside the kernel), the two mc_correctness kernels
# before their redesign (two launches, tie counts and combine; one block
# per (group, candidate)), and belief_aggregate's first design (one warp a
# row, a loop of broadcast loads).
EARLIER_MS = {"flash_attention smollm path": 0.20470094999999994,
              "flash_attention recurrentgemma path": 1.4304699499999998,
              "mamba_scan": 0.7823275999999999,
              "mc_correctness": 0.007682000000000028,
              "mc_correctness_grouped": 0.06899614999999994,
              "belief_aggregate": 0.0021225999999999997}
EARLIER_FROM = "recorded in PERF.md section 6 (not measured in this run)"


def earlier_kernels(rows: list) -> dict:
    """Each redesigned kernel's device ms in this run beside its earlier
    version's recorded ms."""
    now = {f"flash_attention {s['shape'].split(':')[0]}": s["ms"]
           for r in rows if r["name"] == "flash_attention" for s in r["by_shape"]}
    now.update({r["name"]: r["ms"] for r in rows if r["name"] in EARLIER_MS})
    return {k: {"ms": now[k], "earlier_ms": v, "earlier_from": EARLIER_FROM}
            for k, v in EARLIER_MS.items()}


def wide_row(fn, args, bound_of, shape: str) -> dict:
    """An ``mc_correctness`` kernel on the wide kernel's path (L=64 arms):
    bitwise its plain version, device ms and ``call_ms``, beside its
    bound."""
    from repro_torch.kernels import ref

    K = 4
    plain = getattr(ref, f"{fn.__name__}_ref")
    kernel_error(fn.__name__, fn(*args, K), plain(*args, K), f"{shape} (wide kernel)")
    b_ms, b_by = bound_ms(*bound_of(args, K))
    ms, ms_source = device_ms(lambda: fn(*args, K), launches=1)
    return {"shape": shape, "ms": ms, "ms_source": ms_source,
            "call_ms": median_ms(lambda: fn(*args, K)), "bound_ms": b_ms, "bound_by": b_by}


def launch_floor_ms(dev) -> float:
    """Device ms of a one-element ``zero_()``: the least a launch costs."""
    one = torch.zeros(1, device=dev)
    return device_ms(lambda: one.zero_(), n=50, launches=1)[0]


def max_sm_clock_hz() -> float:
    """The card's maximum SM clock, as ``nvidia-smi`` reports it."""
    out = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, check=True).stdout.split()[0]
    return float(out) * 1e6


def mamba_bound(args):
    """(ms, by, detail) of one path-case scan: x and dt read and y written
    in their dtype, h_last written in f32, the B and C columns, A and D
    read once; against 5 f32 flops per (t, d, n) on the CUDA cores and one
    ``ex2`` per (t, d, n) at the SFU's 16 a clock per SM at the maximum SM
    clock. The largest of the three bounds it. The ``ex2`` term is the
    bound of a design that takes every exponential on the SFU: one that
    computed some by polynomial on the FMA pipes could go below it."""
    x, dt, A, Bm, Cm, D, _ = args
    B, S, Din = x.shape
    N = A.shape[1]
    nbytes = (2 * x.numel() * x.element_size() + dt.numel() * dt.element_size() + B * Din * N * 4
              + 2 * B * S * N * Bm.element_size() + A.numel() * 4 + D.numel() * D.element_size())
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_flops = 5.0 * x.numel() * N / F32_OPS_PER_S * 1e3
    clock = max_sm_clock_hz()
    t_ex2 = x.numel() * N / (SFU_EX2_PER_CLOCK_SM * H100_SMS * clock) * 1e3
    detail = {"bytes": nbytes, "bytes_ms": t_bytes, "f32_flops_ms": t_flops,
              "ex2": x.numel() * N, "ex2_ms": t_ex2, "max_sm_clock_mhz": clock / 1e6}
    return max(t_bytes, t_flops, t_ex2), ("bytes" if t_bytes >= max(t_flops, t_ex2) else "operations"), detail


def time_model_kernels(launches: dict, errs: dict) -> list:
    """Each model kernel at the LM-arm route's shapes and dtypes (B=64
    queries, S=127): device ms (profiler), plain ms, bound ms and the
    library yardstick."""
    from repro_torch.kernels import ops, ref

    dev = torch.device("cuda", 0)
    rows = []
    flash_shapes = []
    for label, B, S, T, H, G, hd, w, dtype, _ in FLASH_CASES[:2]:
        args = flash_inputs(B, S, T, H, G, hd, dtype, seed=40, dev=dev)
        ms, ms_source = device_ms(lambda: ops.flash_attention(*args, window=w))
        plain_ms, _ = device_ms(lambda: ref.flash_attention_ref(*args, window=w), n=5)
        b_ms, b_by = bound_ms(*flash_bound(args[0], args[1], w), BF16_OPS_PER_S)
        flash_shapes.append({"shape": f"{label}: B={B} S={S} H={H} G={G} hd={hd} window={w} bf16",
                             "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                             "library_ms": sdpa_ms(*args), "ms_source": ms_source,
                             "call_ms": median_ms(lambda: ops.flash_attention(*args, window=w))})
    main = flash_shapes[1]                 # the heavier (recurrentgemma) shape
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:90",
        "launches": launches["flash_attention"], "max_abs_err": errs["flash_attention"],
        **{k: main[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "shape": main["shape"], "by_shape": flash_shapes,
    })
    args = rglru_inputs(64, 127, 4096, seed=41, dev=dev)
    b_ms, b_by = bound_ms((3 * args[0].numel() + 2 * args[2].numel()) * 4, 3.0 * args[0].numel())
    rows.append({
        "name": "rglru_scan", "route": "cuda", "source": "src/repro_torch/csrc/rglru_scan.cu",
        "replaces": "src/repro/kernels/rglru_scan.py:47", "launches": launches["rglru_scan"],
        "max_abs_err": errs["rglru_scan"], "ms": device_ms(lambda: ops.rglru_scan(*args))[0],
        "plain_ms": device_ms(lambda: ref.rglru_scan_ref(*args), n=3)[0], "bound_ms": b_ms,
        "bound_by": b_by, "library_ms": None, "shape": "B=64 S=127 D=4096",
        "call_ms": median_ms(lambda: ops.rglru_scan(*args)),
    })
    log(f"[profiler rows] rglru_scan, kernel rows of traces of 1 and 20 calls: "
        f"{json.dumps(trace_rows(lambda: ops.rglru_scan(*args)))}")
    B, S, Din, N, R = MAMBA_PATH
    args = mamba_path_inputs(B, S, Din, N, R, seed=42, dev=dev)
    b_ms, b_by, b_detail = mamba_bound(args)
    f32_args = mamba_inputs(B, S, Din, N, seed=43, dev=dev)
    rows.append({
        "name": "mamba_scan", "route": "cuda", "source": "src/repro_torch/csrc/mamba_scan.cu",
        "replaces": "src/repro/kernels/mamba_scan.py:58", "launches": launches["mamba_scan"],
        "max_abs_err": errs["mamba_scan"], "ms": device_ms(lambda: ops.mamba_scan(*args))[0],
        "plain_ms": device_ms(lambda: ref.mamba_scan_ref(*args), n=3)[0], "bound_ms": b_ms,
        "bound_by": b_by, "bound_detail": b_detail, "library_ms": None,
        "bound_note": "operations: every exp on the SFU (16 ex2 a clock per SM), the rate of "
                      "this design; exps partly on the FMA pipes could go below it",
        "shape": f"B={B} S={S} Din={Din} N={N} bf16 x/B/C (B, C strided views), f32 dt, no h0",
        "call_ms": median_ms(lambda: ops.mamba_scan(*args)),
        "f32_ms": device_ms(lambda: ops.mamba_scan(*f32_args))[0],
        "f32_shape": f"B={B} S={S} Din={Din} N={N} f32, contiguous B/C, with h0",
    })
    return rows


# ---------------------------------------------------------------------------
# Phases 11-12: GreedyLLM on MC xi and the paper's baselines
# ---------------------------------------------------------------------------

SWEEP_BUDGETS = (1e-5, 5e-5, 1e-4, 5e-4, 1e-3)        # examples/budget_sweep.py:31


def check_greedy(got, want, label: str) -> float:
    """GreedyLLM's (chosen, value) on the card against the CPU's: equal
    picks and values; returns the value gap (0)."""
    gap = abs(got[1] - want[1])
    if got[0] != want[0] or got[1] != want[1]:
        raise AssertionError(f"GreedyLLM {label}: card picked {got[0]} (xi {got[1]}), "
                             f"cpu {want[0]} (xi {want[1]})")
    return gap


def greedy_phase(dev) -> dict:
    """GreedyLLM on Monte-Carlo xi: the ``mc_correctness`` kernel on the card
    against the plain version on the CPU, over the same draws."""
    from repro_torch.core import (
        McXiEstimator, SuccessProbEstimator, clip_probs, gamma_value_batch, greedy, prng,
        theta_for, xi_exact,
    )

    est_of = lambda where, key, p, K, theta: McXiEstimator(
        prng.key(key, where), p, K, theta, use_kernel=True, device=where)
    cpu = torch.device("cpu")
    gap = 0.0
    # (a) Fig. 11: benchmarks/paper_benches.py::xi_vs_gamma
    t0 = time.perf_counter()
    rng = np.random.default_rng(0)
    diffs = []
    for s in range(40):
        p, b = rng.uniform(0.4, 0.95, 8), rng.uniform(0.1, 0.6, 8)
        got = greedy(p, b, 1.0, est_of(dev, s, p, 4, 8000), empty_value=0.25)
        gap = max(gap, check_greedy(got, greedy(p, b, 1.0, est_of(cpu, s, p, 4, 8000),
                                                empty_value=0.25), f"Fig. 11 seed {s}"))
        s1 = got[0]
        s2, _ = greedy(p, b, 1.0, gamma_value_batch(p), empty_value=0.0)
        x1 = xi_exact(p[s1], 4, p_all=p) if s1 else 0.25
        x2 = xi_exact(p[s2], 4, p_all=p) if s2 else 0.25
        diffs.append(x1 - x2)
    fig11 = {"seeds": 40, "mean_xi_gain": float(np.mean(diffs)), "max_xi_gain": float(np.max(diffs)),
             "seconds": time.perf_counter() - t0}
    log(f"  Fig. 11: 40 seeds card == cpu picks; mean_xi_gain={fig11['mean_xi_gain']:+.4f} "
        f"max={fig11['max_xi_gain']:.4f} in {fig11['seconds']:.1f} s")
    # (b) the serve defaults, every cluster x budget; then K=77 at 5e-4
    serve = {}
    for K, budgets in ((4, SWEEP_BUDGETS), (77, (5e-4,))):
        t0 = time.perf_counter()
        wl, _, history, _ = serve_state(K)
        est = SuccessProbEstimator(history["table"], history["emb"], history["assign"])
        costs = np.asarray(wl.costs, np.float64)
        picks = 0
        for cid, cs in est.clusters.items():
            p = cs.p_hat
            theta = theta_for(0.1, 0.01, float(np.max(clip_probs(p))), 12)
            on_card, on_cpu = est_of(dev, 0, p, K, theta), est_of(cpu, 0, p, K, theta)
            for budget in budgets:
                got = greedy(p, costs, budget, on_card, empty_value=1 / K)
                gap = max(gap, check_greedy(got, greedy(p, costs, budget, on_cpu, empty_value=1 / K),
                                            f"K={K} cluster {cid} budget {budget}"))
                picks += len(got[0])
        serve[f"K={K}"] = {"clusters": len(est.clusters), "budgets": list(budgets),
                           "arms_picked": picks, "seconds": time.perf_counter() - t0}
        log(f"  serve defaults K={K}: {len(est.clusters)} clusters x {len(budgets)} budgets "
            f"card == cpu, {picks} arms picked, in {serve[f'K={K}']['seconds']:.1f} s")
    return {"fig11": fig11, "serve": serve, "max_gap": gap}


def greedy_times(dev) -> dict:
    """Host-clock time of one GreedyLLM selection on the card, ending in its
    last host copy (median of 5 after one warm-up), at the serve defaults'
    longest one: the cluster with the most draws at the largest budget. With
    the kernel and with the plain version on the card; one profiled selection
    with the kernel (device ms by kernel, idle share); and the kernel's
    first-round shape there, at which phase 11's kernel row is timed."""
    from repro_torch.core import (
        McXiEstimator, SuccessProbEstimator, clip_probs, greedy, prng, theta_for,
    )

    wl, _, history, _ = serve_state(4)
    est = SuccessProbEstimator(history["table"], history["emb"], history["assign"])
    costs = np.asarray(wl.costs, np.float64)
    p = max((cs.p_hat for cs in est.clusters.values()),
            key=lambda q: theta_for(0.1, 0.01, float(np.max(clip_probs(q))), 12))
    theta = theta_for(0.1, 0.01, float(np.max(clip_probs(p))), 12)
    budget = SWEEP_BUDGETS[-1]
    out = {"theta": theta, "budget": budget}
    for use_kernel in (True, False):
        xi = McXiEstimator(prng.key(0, dev), p, 4, theta, use_kernel=use_kernel, device=dev)
        sizes = []
        fn = lambda m: (sizes.append(len(m)), xi(m))[1]
        times = []
        for _ in range(6):
            sizes.clear()
            t0 = time.perf_counter()
            greedy(p, costs, budget, fn, empty_value=0.25)
            times.append((time.perf_counter() - t0) * 1e3)
        out["kernel_ms" if use_kernel else "plain_ms"] = float(np.median(times[1:]))
        out["rounds"] = len(sizes)
        if use_kernel:
            out["profiled"] = profiled_split(lambda: greedy(p, costs, budget, xi, empty_value=0.25))
            C = sizes[0]
            masks = np.zeros((C, 12), np.float32)
            masks[np.arange(C), np.flatnonzero(costs <= budget + 1e-15)] = 1.0
            out["args"] = (xi._responses, torch.as_tensor(masks, device=dev), xi._w, xi._empty)
    return out


def sweep_phase(dev) -> dict:
    """The budget sweep at the example's defaults with the router on the card
    and on the CPU: every column equal, budget-aware columns within budget."""
    from repro_torch import budget_sweep

    runs, secs = {}, {}
    for label, where in (("card", dev), ("cpu", "cpu")):
        t0 = time.perf_counter()
        runs[label] = budget_sweep.sweep(device=where)
        torch.cuda.synchronize()
        secs[label] = time.perf_counter() - t0
    card, cpu = runs["card"], runs["cpu"]
    for budget, cols in card["rows"].items():
        for col, (acc, cost) in cols.items():
            want = cpu["rows"][budget][col]
            if (float(acc), float(cost)) != (float(want[0]), float(want[1])):
                raise AssertionError(f"sweep {col} at {budget}: card ({acc}, {cost}) "
                                     f"cpu ({want[0]}, {want[1]})")
            if not (0.0 <= acc <= 1.0 and cost <= budget * (1 + 1e-12)):
                raise AssertionError(f"sweep {col} at {budget}: accuracy {acc}, mean cost {cost}")
    if card["blender"] != cpu["blender"]:
        raise AssertionError(f"sweep blender: card {card['blender']} cpu {cpu['blender']}")
    table = {f"{b:g}": {c: [float(a), float(m)] for c, (a, m) in cols.items()}
             for b, cols in card["rows"].items()}
    table["blender"] = [float(x) for x in card["blender"]]
    log(f"  card == cpu on every column; card {secs['card']:.1f} s, cpu {secs['cpu']:.1f} s")
    log(f"[sweep] {json.dumps(table)}")
    return {"card_s": secs["card"], "cpu_s": secs["cpu"]}


# ---------------------------------------------------------------------------
# Phase 13: a 40-arm pool, past the register kernels' 32 arms
# ---------------------------------------------------------------------------

WIDE_ARMS = 40
WIDE_BUDGETS = (1e-5, 1e-4)


def wide_pool_phase(dev) -> None:
    """The serve defaults over a 40-arm oracle pool at K=4 with
    ``use_kernel=True``: a uniform-budget and a mixed-budget batch of 64
    (the mixed one plans serially, scoring candidates with
    ``mc_correctness_grouped`` over 40 arms), each on the card and on the
    CPU, plans, predictions, schedules, costs and beliefs bitwise; then
    GreedyLLM with ``McXiEstimator(use_kernel=True)`` over the same 40
    arms (the cluster with the most draws, at two budgets), picks and xi
    card vs CPU."""
    from repro_torch import convert
    from repro_torch.core import (
        McXiEstimator, SuccessProbEstimator, clip_probs, greedy, prng, theta_for,
    )

    K = 4
    wl, state, history, arms = serve_state(K, num_arms=WIDE_ARMS)
    work = batches(wl, 2, seed=44)
    results, routers = {}, {}
    for label, where in (("card", dev), ("cpu", torch.device("cpu"))):
        t0 = time.perf_counter()
        routers[label] = convert.router_from_state(
            state, history, arms, K, eps=0.1, delta=0.01, use_kernel=True, device=where,
        )
        results[label] = route_all(routers[label], work)
        torch.cuda.synchronize()
        log(f"  {WIDE_ARMS} arms {label}: 3 routes of 64 in {time.perf_counter() - t0:.2f} s")
    compare_plans(routers["card"], routers["cpu"])
    compare_routes(results["card"], results["cpu"])
    card = results["card"]
    log(f"  {WIDE_ARMS} arms: card == cpu (bitwise), {len(routers['card'].selector._cache)} plans, "
        f"waves {[r.schedule.shape[1] for r in card]}, arms served "
        f"{int((card[1].arm_query_counts > 0).sum())}, accuracy "
        f"{np.mean([np.mean(r.predictions == w[0][:, 1]) for r, w in zip(card, work + work[-1:])]):.3f}")
    est = SuccessProbEstimator(history["table"], history["emb"], history["assign"])
    costs = np.asarray(wl.costs, np.float64)
    theta_of = lambda q: theta_for(0.1, 0.01, float(np.max(clip_probs(q))), WIDE_ARMS)
    p = max((cs.p_hat for cs in est.clusters.values()), key=theta_of)
    picks = {}
    for budget in WIDE_BUDGETS:
        got, want = (greedy(p, costs, budget,
                            McXiEstimator(prng.key(0, where), p, K, theta_of(p), use_kernel=True,
                                          device=where), empty_value=1 / K)
                     for where in (dev, torch.device("cpu")))
        check_greedy(got, want, f"{WIDE_ARMS} arms, budget {budget}")
        picks[budget] = (len(got[0]), got[1])
    log(f"  GreedyLLM over {WIDE_ARMS} arms (theta {theta_of(p)}): card == cpu, "
        f"(arms picked, xi) by budget {picks}")


# ---------------------------------------------------------------------------
# Phase 14: the continuous-batching scheduler at the serve defaults
# ---------------------------------------------------------------------------

SERVE_QUERIES = 500              # launch/serve.py --queries
SERVE_BUDGET = 1e-4              # --budget
SERVE_FAULT_RATE = 0.1           # --fault-rate: split 50/30/20 over timeout/error/degrade
SERVE_DRIFT_AFTER = 250          # --drift-after
SERVE_PROBE_RATE = 0.02          # --probe-rate
SERVE_TIERS = (2.5e-5, 5e-5, 1e-4)   # the ledger's downgrade ladder
LEDGER_SHARE = 0.8               # the limited tenant's share of its unlimited spend


def serve_stream(where, use_kernel: bool, limit, stream) -> dict:
    """``launch/serve.py --queries 500 --budget 1e-4 --fault-rate 0.1
    --drift-after 250 --probe-rate 0.02`` at ``--qps 0`` (the floodgates)
    on the port, with a ``CostLedger`` whose tenant "acme" (every other
    request) is limited to ``limit`` USD (None: unlimited): fresh workload,
    pool, fault policy and estimator; blocks of ``max_batch`` submitted and
    drained in turn, their labels recorded, the truth drifted after 250
    queries; then one mixed-budget block of 64 (budgets the 0.3 and 0.8
    cost quantiles x 2.5) admitted by ``flush()``, one heterogeneous route
    whose plan misses plan serially. Admission is by size, never by the
    clock. Returns the blocks, the counters, the ledger snapshot and the
    stream's wall time."""
    from repro_torch import convert
    from repro_torch.distributed.fault import FaultPolicy
    from repro_torch.serving import BatchScheduler, CostLedger, FeedbackLog

    wl_state, history, arms, payloads, qemb, labels, mixed = stream
    router = convert.router_from_state(wl_state, history, arms, 4, eps=0.1, delta=0.01,
                                       use_kernel=use_kernel, device=where)
    engine = router.engine
    wl = engine.arms[0].workload
    engine.fault_policy = FaultPolicy(len(arms), 4, seed=7).set_arms(
        range(len(arms)), timeout=0.5 * SERVE_FAULT_RATE, error=0.3 * SERVE_FAULT_RATE,
        degrade=0.2 * SERVE_FAULT_RATE)
    ledger = CostLedger(num_arms=len(arms))
    if limit is not None:
        ledger.set_limit("acme", limit)
    sched = BatchScheduler(router, max_batch=64, max_wait_s=0.002,
                           feedback=FeedbackLog(router.estimator, probe_rate=SERVE_PROBE_RATE),
                           ledger=ledger, budget_tiers=SERVE_TIERS)
    sched.prewarm(budgets=[SERVE_BUDGET])
    tenants = np.where(np.arange(SERVE_QUERIES) % 2 == 0, "acme", "zen").astype(object)
    drifted = False
    blocks = []
    t0 = time.perf_counter()
    for lo in range(0, SERVE_QUERIES, 64):
        hi = min(SERVE_QUERIES, lo + 64)
        blk = sched.submit_many(payloads[lo:hi], qemb[lo:hi], SERVE_BUDGET, tenant=tenants[lo:hi])
        sched.drain()
        sched.record_outcomes(blk.request_ids, labels[lo:hi])
        blocks.append(blk)
        if not drifted and hi >= SERVE_DRIFT_AFTER:
            drifted = True
            for t in range(3):           # half of the 6 clusters
                wl.drift_arms(router.plans.plan(t, SERVE_BUDGET).order, 0.30, clusters=[t])
    sched.apply_feedback()
    m_pay, m_emb, m_bud = mixed
    blk = sched.submit_many(m_pay, m_emb, m_bud, tenant="zen")
    sched.flush()
    blocks.append(blk)
    if where.type == "cuda":
        torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    stats = dict(sched.stats)
    return {"blocks": blocks, "stats": stats, "ledger": json.dumps(ledger.snapshot(), sort_keys=True),
            "wall_s": wall_s, "latency": sched.latency_stats(), "labels": labels,
            "acme_spent": ledger.tenant("acme")["spent"]}


def stream_inputs():
    """The serve-default state and one 500-query stream, made once."""
    wl, wl_state, history, arms = serve_state(K=4)
    rng = np.random.default_rng(1)
    cid, qemb, labels = wl.sample_queries(SERVE_QUERIES, rng)
    mcid, memb, mlab = wl.sample_queries(64, rng)
    mixed_budgets = rng.choice(np.quantile(wl.costs, [0.3, 0.8]) * 2.5, size=64)
    return (wl_state, history, arms, np.column_stack([cid, labels]), qemb, labels,
            (np.column_stack([mcid, mlab]), memb, mixed_budgets))


def compare_streams(card: dict, cpu: dict, label: str) -> None:
    """Every time-free result of two ``serve_stream`` runs, bitwise."""
    for i, (g, c) in enumerate(zip(card["blocks"], cpu["blocks"])):
        for field in ("predictions", "costs", "planned_costs", "clusters", "budgets",
                      "stop_waves", "modes", "request_ids"):
            a, b = getattr(g, field), getattr(c, field)
            if not np.array_equal(a, b):
                rows = np.flatnonzero(a != b)
                raise AssertionError(f"{label} block {i}: {field} differ at rows "
                                     f"{rows[:10].tolist()}: card {a[rows[:3]].tolist()} "
                                     f"cpu {b[rows[:3]].tolist()}")
    if card["stats"] != cpu["stats"]:
        diff = {k: (card["stats"][k], cpu["stats"].get(k)) for k in card["stats"]
                if card["stats"][k] != cpu["stats"].get(k)}
        raise AssertionError(f"{label}: scheduler counters differ: {diff}")
    if card["ledger"] != cpu["ledger"]:
        raise AssertionError(f"{label}: ledger snapshots differ")


def stream_summary(run: dict, launches: dict) -> dict:
    st = run["stats"]
    preds = np.concatenate([b.predictions for b in run["blocks"][:-1]])
    lat = run["latency"]
    return {
        "qps": st["completed"] / run["wall_s"], "p50_ms": lat["p50_s"] * 1e3,
        "p99_ms": lat["p99_s"] * 1e3, "accuracy": float(np.mean(preds == run["labels"])),
        "planes": {"jit": st["spec_jit"], "reference": st["spec_reference"]},
        "flushes": st["flushes"], "groups": st["batches"],
        "plan": {k: st[f"plan_{k}"] for k in ("hits", "misses", "prefetches", "batch_replans",
                                             "batch_replanned", "stale_dropped")},
        "attempted_failures": st["degradation_failures"], "degraded": st["degradation_degraded"],
        "drifts": st["feedback_drifts"], "probes": st["feedback_probes"],
        "rejected": st["ledger_rejected"], "downgraded": st["ledger_downgraded"],
        "completed": st["completed"], "launches": launches,
    }


def poisson_stream(dev, stream, qps: float = 5000.0, slo_ms: float = 50.0) -> dict:
    """``--qps 5000 --slo-ms 50`` with the same faults and probes (labels
    recorded as blocks complete; no drift, no ledger), on the card: Poisson arrivals submitted in the bursts the
    clock delivers, the scheduler pumped between them (serve.py's loop).
    Timing only: arrivals follow the clock, so this run is not compared."""
    from repro_torch import convert
    from repro_torch.distributed.fault import FaultPolicy
    from repro_torch.serving import BatchScheduler, FeedbackLog

    wl_state, history, arms, payloads, qemb, labels, _ = stream
    router = convert.router_from_state(wl_state, history, arms, 4, eps=0.1, delta=0.01,
                                       use_kernel=True, device=dev)
    router.engine.fault_policy = FaultPolicy(len(arms), 4, seed=7).set_arms(
        range(len(arms)), timeout=0.05, error=0.03, degrade=0.02)
    sched = BatchScheduler(router, max_batch=64, max_wait_s=0.002,
                           feedback=FeedbackLog(router.estimator, probe_rate=SERVE_PROBE_RATE))
    sched.prewarm(budgets=[SERVE_BUDGET])
    rng = np.random.default_rng(2)
    t0 = time.monotonic()
    arrivals = t0 + np.cumsum(rng.exponential(1.0 / qps, SERVE_QUERIES))
    blocks, sent, recorded = [], 0, 0
    while sent < SERVE_QUERIES:
        due = int(np.searchsorted(arrivals, time.monotonic(), side="right"))
        if due > sent:
            blocks.append((sched.submit_many(payloads[sent:due], qemb[sent:due], SERVE_BUDGET,
                                             slo_s=slo_ms / 1e3, arrival_s=arrivals[sent:due]),
                           labels[sent:due]))
            sent = due
        sched.pump()
        while recorded < len(blocks) and blocks[recorded][0].done():
            sched.record_outcomes(blocks[recorded][0].request_ids, blocks[recorded][1])
            recorded += 1
    sched.drain()
    torch.cuda.synchronize()
    wall_s = time.monotonic() - t0
    lat = sched.latency_stats()
    preds = np.concatenate([b.predictions for b, _ in blocks])
    return {"offered_qps": qps, "slo_ms": slo_ms, "qps": lat["count"] / wall_s,
            "p50_ms": lat["p50_s"] * 1e3, "p99_ms": lat["p99_s"] * 1e3,
            "accuracy": float(np.mean(preds == labels)), "flushes": sched.stats["flushes"],
            "groups": sched.stats["batches"]}


def scheduler_phase(dev) -> dict:
    """The serve-default stream through ``BatchScheduler`` with faults,
    feedback and a cost ledger, ``use_kernel`` off and on, each on the card
    and on the CPU: every block's predictions, costs, planned costs,
    clusters, budgets, stop waves, modes and request ids, every counter
    and the ledger's snapshot bitwise. The limited tenant's limit is 80% of
    its spend in an unlimited CPU run. The launch counters are zeroed
    before and read after each card run; with ``use_kernel`` on,
    ``belief_aggregate`` and ``mc_correctness_grouped`` must both be above
    0. Then, on the card only: a Poisson stream, and the device's idle
    share of one profiled floodgates stream."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import ops

    cpu = torch.device("cpu")
    stream = stream_inputs()
    limit = LEDGER_SHARE * serve_stream(cpu, False, None, stream)["acme_spent"]
    out = {"acme_limit_usd": limit}
    for use_kernel in (False, True):
        ops.reset_launch_counts()
        card = serve_stream(dev, use_kernel, limit, stream)
        launches = {name: getattr(ops, name).launches
                    for name in ("belief_aggregate", "mc_correctness_grouped")}
        on_cpu = serve_stream(cpu, use_kernel, limit, stream)
        compare_streams(card, on_cpu, f"use_kernel={use_kernel}")
        row = stream_summary(card, launches)
        row["cpu_qps"] = on_cpu["stats"]["completed"] / on_cpu["wall_s"]
        out["kernel" if use_kernel else "f64"] = row
        log(f"  use_kernel={use_kernel}: card == cpu (bitwise: {len(card['blocks'])} blocks, "
            f"counters, ledger); {json.dumps(row)}")
        if use_kernel:
            for name, n in launches.items():
                if n <= 0:
                    raise AssertionError(f"kernel {name} was never launched by the scheduler")
        if row["rejected"] + row["downgraded"] == 0 or row["attempted_failures"] == 0:
            raise AssertionError(f"the stream exercised no ledger limit or no fault: {row}")
    out["poisson"] = poisson_stream(dev, stream)
    log(f"  poisson: {json.dumps(out['poisson'])}")
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run = serve_stream(dev, True, limit, stream)
    busy = sum(e.self_device_time_total for e in device_events(prof)) / 1e6
    out["profiled"] = {"wall_s": run["wall_s"], "device_busy_s": busy,
                       "idle_share": 1.0 - busy / run["wall_s"]}
    log(f"  profiled floodgates stream (use_kernel=True): {json.dumps(out['profiled'])}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT}/src/repro_torch not found; run from a checkout of the repo",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # f32 results are compared below: full f32 matmuls and convolutions, no TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.core.mc import bucket_size
    from repro_torch.kernels import _build, ops, ref

    dev = torch.device("cuda", 0)
    phases = {}

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[1 report] {smi}")
    log(f"  torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")

    t0 = time.perf_counter()
    paths = _build.build()
    phases["build_s"] = time.perf_counter() - t0
    log(f"[2 build] {len(paths)} kernels in {phases['build_s']:.1f} s: "
        + ", ".join(p.name for p in paths.values()))
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(paths["flash_attention"])],
                          capture_output=True, text=True, check=True).stdout
    mma = sum(1 for line in sass.splitlines() if "HGMMA" in line or "HMMA" in line)
    log(f"  tensor-core instructions (HGMMA|HMMA) in {paths['flash_attention'].name}: {mma}")
    if mma == 0:
        raise AssertionError("the flash_attention library holds no tensor-core instruction")

    t0 = time.perf_counter()
    log("[3 kernels vs plain, on the card]")
    errs = check_kernels(dev)
    lifted = errs.pop("lifted")
    phases["kernels_s"] = time.perf_counter() - t0

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    log("[4 route at the serve defaults: card vs cpu]")
    shapes = route_phase(dev)
    phases["route_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log("[5 route K=77 with use_kernel=True]")
    k77_phase(dev)
    phases["k77_s"] = time.perf_counter() - t0
    launches = {
        "belief_aggregate": ops.belief_aggregate.launches,
        "mc_correctness_grouped": ops.mc_correctness_grouped.launches,
    }
    log(f"[6 launches on the main path] {launches}")
    for name, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was never launched on the main path")

    routes = route_times(dev)
    log(f"[routes] {json.dumps(routes)}")

    # time each kernel at the shape the main path gave it
    T = shapes["belief_T"]
    Tp = bucket_size(shapes["mc_theta"], 256)
    ba_args = belief_inputs(64, T, 4, True, seed=1, dev=dev)
    mc_args = mc_inputs(1, Tp, 12, 4, 3, seed=2, dev=dev)
    kernels = []
    for name, fn, plain, args, nb_ops, shape, replaces, source in (
        ("belief_aggregate", ops.belief_aggregate, ref.belief_aggregate_ref, ba_args,
         belief_bound(ba_args[0], 4), f"rows={64 * (T + 1)} M={T} K=4",
         "src/repro/kernels/belief_aggregate.py:42",
         "src/repro_torch/csrc/belief_aggregate.cu"),
        ("mc_correctness_grouped", ops.mc_correctness_grouped, ref.mc_correctness_grouped_ref,
         mc_args, mc_bound(mc_args, 4), f"G=1 C=3 T={Tp} L=12 K=4",
         "src/repro/kernels/mc_correctness.py:174",
         "src/repro_torch/csrc/mc_correctness_grouped.cu"),
    ):
        err = kernel_error(name, fn(*args, 4), plain(*args, 4), f"{shape} (main path)")
        errs[name] = max(errs[name], err)
        ms, ms_source = device_ms(lambda: fn(*args, 4), launches=1)
        plain_ms, plain_source = device_ms(lambda: plain(*args, 4), n=5)
        b_ms, b_by = bound_ms(*nb_ops)
        kernels.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "shape": shape, "ms_source": ms_source,
            "plain_ms_source": plain_source,
            "call_ms": median_ms(lambda: fn(*args, 4)),
            "plain_call_ms": median_ms(lambda: plain(*args, 4), reps=5, inner=5),
        })
        kernels[-1]["bitwise"] = errs[name] == 0.0
        if name == "mc_correctness_grouped":
            kernels[-1]["wide"] = wide_row(fn, mc_inputs(1, Tp, 64, 4, 3, seed=6, dev=dev),
                                           mc_bound, f"G=1 C=3 T={Tp} L=64 K=4")
    rows = trace_rows(lambda: ops.belief_aggregate(*ba_args, 4))
    log(f"[profiler rows] belief_aggregate, kernel rows of traces of 1 and 20 calls: "
        f"{json.dumps(rows)}")

    t0 = time.perf_counter()
    log("[7 model kernels vs plain, on the card]")
    errs.update(check_model_kernels(dev))
    phases["model_kernels_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log("[8 one pattern unit of each family, full width, f32: card vs cpu]")
    model_phase(dev)
    phases["models_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    log("[9 LM-arm route: three full-width bf16 arms, use_kernel=True]")
    lm = lm_route_phase(dev)
    phases["lm_route_s"] = time.perf_counter() - t0
    for row in kernels:                 # slice-1 kernels' launches on this path too
        row["lm_route_launches"] = lm["launches"][row["name"]]
    t0 = time.perf_counter()
    log("[10 model kernels timed at the LM-arm route's shapes]")
    model_rows = time_model_kernels(lm["launches"], errs)
    kernels += model_rows
    phases["model_timing_s"] = time.perf_counter() - t0
    log(f"[lm arms] {json.dumps({k: lm[k] for k in ('forward_ms', 'init_s', 'main_s', 'breakdown')})}")

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    log("[11 GreedyLLM on MC xi: mc_correctness on the card vs the cpu]")
    greedy_res = greedy_phase(dev)
    mc_launches = ops.mc_correctness.launches
    phases["greedy_s"] = time.perf_counter() - t0
    log(f"  mc_correctness launches in phase 11: {mc_launches}")
    if mc_launches <= 0:
        raise AssertionError("kernel mc_correctness was never launched by GreedyLLM")
    gt = greedy_times(dev)
    args = gt.pop("args")
    log(f"[greedy] {json.dumps({**greedy_res, 'selection': gt})}")
    T1, C1 = args[0].shape[0], args[1].shape[0]
    shape = f"T={T1} L=12 C={C1} K=4"
    err = kernel_error("mc_correctness", ops.mc_correctness(*args, 4),
                       ref.mc_correctness_ref(*args, 4), f"{shape} (phase 11)")
    errs["mc_correctness"] = max(errs["mc_correctness"], err)
    ms, ms_source = device_ms(lambda: ops.mc_correctness(*args, 4), launches=1)
    plain_ms, plain_source = device_ms(lambda: ref.mc_correctness_ref(*args, 4), n=5)
    b_ms, b_by = bound_ms(*single_bound(args, 4))
    kernels.append({
        "name": "mc_correctness", "route": "cuda",
        "source": "src/repro_torch/csrc/mc_correctness.cu",
        "replaces": "src/repro/kernels/mc_correctness.py:79",
        "launches": mc_launches, "max_abs_err": errs["mc_correctness"],
        "bitwise": errs["mc_correctness"] == 0.0,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "library_ms": None, "shape": shape, "ms_source": ms_source,
        "plain_ms_source": plain_source,
        "call_ms": median_ms(lambda: ops.mc_correctness(*args, 4)),
        "plain_call_ms": median_ms(lambda: ref.mc_correctness_ref(*args, 4), reps=5, inner=5),
        "wide": wide_row(ops.mc_correctness, single_inputs(T1, 64, 12, 4, seed=7, dev=dev),
                         single_bound, f"T={T1} L=64 C=12 K=4"),
    })

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    log("[12 budget sweep at the example's defaults: card vs cpu]")
    sweep_phase(dev)
    phases["sweep_s"] = time.perf_counter() - t0
    log(f"  kernel launches in phase 12: mc_correctness {ops.mc_correctness.launches}, "
        f"belief_aggregate {ops.belief_aggregate.launches}, "
        f"mc_correctness_grouped {ops.mc_correctness_grouped.launches}")

    ops.reset_launch_counts()
    t0 = time.perf_counter()
    log(f"[13 a {WIDE_ARMS}-arm pool: routes and GreedyLLM, card vs cpu]")
    wide_pool_phase(dev)
    wide_launches = {name: getattr(ops, name).launches
                     for name in ("belief_aggregate", "mc_correctness_grouped", "mc_correctness")}
    phases["wide_pool_s"] = time.perf_counter() - t0
    log(f"  launches in phase 13: {wide_launches}")
    for name, n in wide_launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {name} was never launched on the {WIDE_ARMS}-arm path")
    for row in kernels:
        if row["name"] in wide_launches:
            row["wide_pool_launches"] = wide_launches[row["name"]]

    t0 = time.perf_counter()
    log("[14 the scheduler at the serve defaults: faults, feedback, ledger; card vs cpu]")
    sched = scheduler_phase(dev)
    phases["scheduler_s"] = time.perf_counter() - t0
    log(f"[scheduler] {json.dumps(sched)}")
    for row in kernels:
        if row["name"] in ("belief_aggregate", "mc_correctness_grouped"):
            row["scheduler_launches"] = sched["kernel"]["launches"][row["name"]]
        if row["name"] in ("flash_attention", "rglru_scan", "mamba_scan", "belief_aggregate"):
            row["lm_scheduler_launches"] = lm["scheduler_launches"][row["name"]]
        if row["name"] in ("mc_correctness", "mc_correctness_grouped"):
            row["lifted"] = [r for r in lifted if r["name"] == row["name"]]
    log(f"[earlier kernels] {json.dumps(earlier_kernels(kernels))}")
    floor = launch_floor_ms(dev)
    for row in kernels:
        row["launch_floor_ms"] = floor
    log(f"[phases] {json.dumps({k: round(v, 3) for k, v in phases.items()})}")
    log(f"[profiler traces] {json.dumps(TRACES)}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
