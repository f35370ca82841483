#!/usr/bin/env python3
"""Drive the PyTorch port's serving path on one CUDA card and check it.

    python3 chip_smoke.py

Phases:

1. report — the card (``nvidia-smi`` name and power limit), torch and CUDA;
2. build — compile every CUDA kernel of ``src/repro_torch/csrc`` (timed as
   set-up);
3. kernels vs plain — each kernel against its plain PyTorch version on the
   same CUDA tensors: ``belief_aggregate`` at (130, 12, 77) and at the
   router's prefix-expanded shape for K=4 and K=77 (beliefs to 1e-6,
   predictions exact); ``mc_correctness_grouped`` at planner shapes
   (G in {1, 8}, C=3, T=16384, L=12, K in {4, 77}) to 2e-6;
4. route — the serve defaults (12 arms, K=4, 6 clusters, history 2000,
   batches of 64, eps 0.1, delta 0.01): uniform-budget batches (batched
   planner + device wave loop) and mixed-budget batches (serial planner,
   which scores candidates with ``mc_correctness_grouped`` under
   ``use_kernel``), with ``use_kernel`` off and on, each held against the
   same routes run by the port on the CPU: the f64 planes bitwise, the
   kernel planes to equal plans, predictions and stop waves, beliefs within
   1e-6 and candidate xi within 2e-6;
5. K=77 — one batch over a 77-class label space with ``use_kernel=True``;
6. launches — both kernels' launch counters, zeroed just before phase 4,
   must be above 0 after phase 5; then one route of 64 is timed cold and
   warm on the card, and each kernel is checked against its plain version
   and timed at the shape the main path gave it.

Two lines before the last is a JSON object listing every kernel with its
launches, error, bound and times — ``ms``/``plain_ms`` are device time per
call from a ``torch.profiler`` trace, ``call_ms``/``plain_call_ms`` the
CUDA-event wall time per call, host dispatch included; the line before the
last is the card's name and power limit; the last line is
``{"ok": true, "device": {...}}``. Any failed phase raises and the script
exits non-zero; without a CUDA device, or without the repository's
``src/repro_torch`` beside it, it exits non-zero before printing a result.
"""
from __future__ import annotations

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
BELIEF_ATOL = 1e-6
XI_ATOL = 2e-6


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


def device_ms(fn, n: int = 20):
    """Device time per call of ``fn``: the summed device time of every kernel
    it launches, from a ``torch.profiler`` trace of ``n`` calls. Returns
    ``(ms, "profiler")``, or the CUDA-event wall time per call with
    ``"events"`` if the trace holds no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(
        getattr(e, "self_device_time_total", getattr(e, "self_cuda_time_total", 0.0))
        for e in prof.key_averages()
    )
    if us > 0:
        return us / n / 1e3, "profiler"
    return median_ms(fn), "events"


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
            est.empty, est.valid, est.theta_f.to(torch.float32))


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


def bound_ms(nbytes, ops):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 3: kernels vs their plain versions on the card
# ---------------------------------------------------------------------------


def kernel_error(name: str, got, want, label: str) -> float:
    """Max abs error of a kernel's output against its plain version's on the
    same inputs; raises, printing the rows concerned, past the tolerance
    (or on any differing prediction)."""
    torch.cuda.synchronize()
    if name == "belief_aggregate":
        (bel, pred), (bel_p, pred_p) = got, want
        err = float((bel - bel_p).abs().max())
        bad = torch.nonzero(pred != pred_p)[:, 0].tolist()
        log(f"  {name} {label}: max_abs_err={err:.3g} pred_mismatch={len(bad)}")
        if not err <= BELIEF_ATOL or bad:
            raise AssertionError(
                f"{name} disagrees with its plain version at {label}: err {err}, "
                f"rows {bad[:10]} kernel {pred[bad[:10]].tolist()} plain {pred_p[bad[:10]].tolist()}"
            )
        return err
    err = float((got - want).abs().max())
    log(f"  {name} {label}: max_abs_err={err:.3g}")
    if not err <= XI_ATOL:
        raise AssertionError(
            f"{name} disagrees with its plain version at {label}: "
            f"kernel {got.tolist()} plain {want.tolist()}"
        )
    return err


def check_kernels(dev) -> dict:
    from repro_torch.kernels import ops, ref

    errs = {"belief_aggregate": 0.0, "mc_correctness_grouped": 0.0}
    for rows_b, T, K, prefix in ((130, 12, 77, False), (64, 12, 4, True), (64, 12, 77, True)):
        args = belief_inputs(rows_b, T, K, prefix, seed=rows_b + K, dev=dev)
        err = kernel_error("belief_aggregate", ops.belief_aggregate(*args, K),
                           ref.belief_aggregate_ref(*args, K),
                           f"rows={args[0].shape[0]} M={T} K={K}")
        errs["belief_aggregate"] = max(errs["belief_aggregate"], err)
    for G in (1, 8):
        for K in (4, 77):
            args = mc_inputs(G, 16384, 12, K, 3, seed=G * 100 + K, dev=dev)
            err = kernel_error("mc_correctness_grouped", ops.mc_correctness_grouped(*args, K),
                               ref.mc_correctness_grouped_ref(*args, K),
                               f"G={G} C=3 T=16384 L=12 K={K}")
            errs["mc_correctness_grouped"] = max(errs["mc_correctness_grouped"], err)
    return errs


# ---------------------------------------------------------------------------
# Phases 4-5: route on the card, hold it against the CPU
# ---------------------------------------------------------------------------


def serve_state(K: int, seed: int = 0):
    """The serve defaults: a 12-arm oracle pool over 6 clusters, calibrated
    from 2000 historical responses."""
    from repro_torch import convert
    from repro_torch.core.clustering import kmeans
    from repro_torch.data.synth import OracleWorkload

    wl = OracleWorkload(num_classes=K, num_clusters=6, num_arms=12, seed=seed)
    table, emb, _ = wl.response_table(2000, seed=1)
    assign, _ = kmeans(emb, 6, seed=0)
    arms = [{"name": f"llm-{i}", "arm_index": i, "seed": 9, "metered": False} for i in range(12)]
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


def compare_plans(gpu, cpu, exact: bool) -> None:
    if gpu.selector._cache.keys() != cpu.selector._cache.keys():
        raise AssertionError("the two devices planned different (p, K, budget) pairs")
    for key, s in gpu.selector._cache.items():
        c = cpu.selector._cache[key]
        same_sets = (np.array_equal(s.chosen, c.chosen) and s.l_star == c.l_star
                     and (s.s1 is None) == (c.s1 is None)
                     and (s.s1 is None or (np.array_equal(s.s1, c.s1) and np.array_equal(s.s2, c.s2))))
        xi = np.array([s.xi_est, s.xi_s1, s.xi_s2])
        xi_c = np.array([c.xi_est, c.xi_s1, c.xi_s2])
        ok = same_sets and (np.array_equal(xi, xi_c) if exact else np.abs(xi - xi_c).max() <= XI_ATOL)
        if exact:
            ok = ok and s.cost == c.cost and s.p_star == c.p_star and s.gamma_s2 == c.gamma_s2
        if not ok:
            raise AssertionError(
                f"plan mismatch at budget {key[2]}: card chosen={s.chosen} s1={s.s1} s2={s.s2} "
                f"xi={xi.tolist()} / cpu chosen={c.chosen} s1={c.s1} s2={c.s2} xi={xi_c.tolist()}"
            )


def compare_routes(gpu_res, cpu_res, exact: bool) -> None:
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
        if (exact and not np.array_equal(g.beliefs, c.beliefs)) or err > BELIEF_ATOL:
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
        compare_plans(routers["card"], routers["cpu"], exact=not use_kernel)
        compare_routes(results["card"], results["cpu"], exact=not use_kernel)
        log(f"  use_kernel={use_kernel}: card == cpu "
            f"({'bitwise' if not use_kernel else 'within tolerance'}), "
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card", file=sys.stderr)
        return 2
    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        print(f"chip_smoke: {ROOT}/src/repro_torch not found; run from a checkout of the repo",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
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

    t0 = time.perf_counter()
    log("[3 kernels vs plain, on the card]")
    errs = check_kernels(dev)
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
        ms, ms_source = device_ms(lambda: fn(*args, 4))
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
    log(f"[phases] {json.dumps({k: round(v, 3) for k, v in phases.items()})}")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
