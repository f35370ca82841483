"""The port's continuous-batching BatchScheduler against the JAX package's:
``tests/test_scheduler_continuous.py``'s scenarios on both packages from
the same seeds (tabular arms: responses are a pure function of the query,
so admission order, budget grouping and speculation cannot change an
answer).

Each scenario asserts the reference's own contract on both packages —
continuous == one-shot, saturation coalescing, block == single submits,
the speculation switch, wave-stepped completion, stats consistency, SLO
admission and queue-composition prefetch, the one-shot ``flush`` API — and
the port's per-request results (predictions, costs, planned costs, stop
waves, modes, request ids) and counters equal the reference's bitwise.
Admission is by size (``drain``/``flush``), never by the clock. The kernel
plane (``use_kernel=True``, the plain version here) is held to the
reference's with the f32 stop-boundary caveat counted.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):      # removed in jax 0.9
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np
import pytest

from _torch_serving import (
    PACKAGES,
    PORT,
    assert_blocks_equal,
    both,
    one_torch_thread,  # noqa: F401  (autouse: torch on one CPU thread)
    tabular_pool,
)

TIME_FREE = ("prediction", "cost", "planned_cost", "cluster", "budget", "stop_wave", "mode",
             "request_id")


def _pool(pkg, B=96, metered=False, **kw):
    _, engine, router, qemb, _ = tabular_pool(pkg, B=B, metered=metered, **kw)
    return engine, router, qemb


def _results(futs):
    return [tuple(getattr(f.result(), k) for k in TIME_FREE) for f in futs]


def _stats(sched):
    return {k: v for k, v in sched.stats.items()}


def _oneshot_stream(router, qemb, budgets, max_batch):
    B = budgets.shape[0]
    preds, costs = np.zeros(B, np.int64), np.zeros(B, np.float64)
    stop_waves = np.zeros(B, np.int64)
    for s in range(0, B, max_batch):
        rows = np.arange(s, min(s + max_batch, B))
        cb = budgets[rows]
        if (cb == cb[0]).all():
            groups = [rows]
        else:
            _, first = np.unique(cb, return_index=True)
            groups = [rows[cb == cb[i]] for i in np.sort(first)]
        for g in groups:
            res = router.route_batch(g, qemb[g], budgets[g])
            preds[g], costs[g], stop_waves[g] = res.predictions, res.costs, res.stop_waves
    return preds, costs, stop_waves


@pytest.mark.parametrize("hetero", [False, True])
def test_continuous_matches_oneshot_stream(hetero):
    def scenario(pkg):
        engine, router, qemb = _pool(pkg)
        B = qemb.shape[0]
        levels = np.quantile(engine.costs, [0.4, 0.8]) * 2.5
        budgets = (np.random.default_rng(11).choice(levels, size=B) if hetero
                   else np.full(B, float(levels[1])))
        sched = pkg.BatchScheduler(router, max_batch=32, max_wait_s=0.0)
        futs = [sched.submit(pkg.Request(payload=j, embedding=qemb[j], budget=budgets[j]))
                for j in range(B)]
        sched.drain()
        _, router2, _ = _pool(pkg)
        preds, costs, stop_waves = _oneshot_stream(router2, qemb, budgets, 32)
        assert all(f.done() for f in futs)
        results = [f.result() for f in futs]
        np.testing.assert_array_equal([r.prediction for r in results], preds)
        np.testing.assert_allclose([r.cost for r in results], costs, rtol=1e-12, atol=0)
        np.testing.assert_array_equal([r.stop_wave for r in results], stop_waves)
        assert all(r.mode == "jit" for r in results)
        return {"results": _results(futs), "stats": _stats(sched)}
    both(scenario)


def test_saturation_coalescing_matches_oneshot_and_caps_admission():
    def scenario(pkg):
        engine, router, qemb = _pool(pkg)
        _, router2, _ = _pool(pkg)
        budget = float(np.quantile(engine.costs, 0.6)) * 2
        sched = pkg.BatchScheduler(router, max_batch=16, max_wait_s=0.0, coalesce=3)
        blk = sched.submit_many(np.arange(96), qemb, budget)
        sched.drain()
        assert sched.stats["flushes"] == 2
        preds, costs, _ = _oneshot_stream(router2, qemb, np.full(96, budget), 48)
        np.testing.assert_array_equal(blk.predictions, preds)
        np.testing.assert_allclose(blk.costs, costs, rtol=1e-12, atol=0)
        sched2 = pkg.BatchScheduler(router, max_batch=16, max_wait_s=0.0, coalesce=3)
        sched2.submit_many(np.arange(96), qemb, budget)
        (batch, res) = sched2.flush()[0]
        assert len(batch) == 16 and res.predictions.shape[0] == 16
        return {"blk": blk, "route": res, "stats": _stats(sched)}
    both(scenario)


def test_block_submission_matches_single_submits():
    def scenario(pkg):
        engine, router, qemb = _pool(pkg, B=64)
        _, router2, _ = _pool(pkg, B=64)
        budget = float(np.quantile(engine.costs, 0.6)) * 2
        sched1 = pkg.BatchScheduler(router, max_batch=16, max_wait_s=0.0)
        futs = [sched1.submit(pkg.Request(payload=j, embedding=qemb[j], budget=budget))
                for j in range(64)]
        sched1.drain()
        sched2 = pkg.BatchScheduler(router2, max_batch=16, max_wait_s=0.0)
        blk = sched2.submit_many(np.arange(64), qemb, budget)
        sched2.drain()
        np.testing.assert_array_equal(blk.predictions, [f.result().prediction for f in futs])
        np.testing.assert_allclose(blk.costs, [f.result().cost for f in futs], rtol=1e-12,
                                   atol=0)
        np.testing.assert_array_equal(blk.stop_waves, [f.result().stop_wave for f in futs])
        assert blk.done() and blk.result() is blk
        return {"blk": blk, "results": _results(futs)}
    both(scenario)


def test_speculation_switch_metered_vs_oracle():
    def scenario(pkg):
        _, router_free, qemb = _pool(pkg, B=48)
        engine_m, router_m, _ = _pool(pkg, B=48, metered=True)
        budget = float(np.quantile(engine_m.costs, 0.6)) * 2
        out = {}
        for tag, router, kw in (("free", router_free, {}), ("metered", router_m, {}),
                                ("threshold", router_m, {"speculation_threshold": budget}),
                                ("pinned", router_m, {"speculation": "jit"})):
            sched = pkg.BatchScheduler(router, max_batch=16, max_wait_s=0.0, **kw)
            blk = sched.submit_many(np.arange(48), qemb, budget)
            sched.drain()
            out[tag] = blk
            out["stats_" + tag] = {k: sched.stats[k] for k in ("spec_jit", "spec_reference")}
        assert set(out["free"].modes.tolist()) == {"jit"}
        assert out["stats_free"] == {"spec_jit": 3, "spec_reference": 0}
        assert set(out["metered"].modes.tolist()) == {"reference"}
        assert out["stats_metered"] == {"spec_jit": 0, "spec_reference": 3}
        np.testing.assert_array_equal(out["free"].predictions, out["metered"].predictions)
        np.testing.assert_allclose(out["free"].costs, out["metered"].costs, rtol=1e-12, atol=0)
        assert set(out["threshold"].modes.tolist()) == {"jit"}
        assert set(out["pinned"].modes.tolist()) == {"jit"}
        return out
    both(scenario)


def test_speculation_cost_metadata():
    def scenario(pkg):
        engine_free, router_free, qemb = _pool(pkg, B=16)
        engine_m, router_m, _ = _pool(pkg, B=16, metered=True)
        budget = float(np.quantile(engine_free.costs, 0.6)) * 2
        assert not engine_free.any_metered and engine_m.any_metered
        p_free = router_free.begin_route(np.arange(16), qemb, budget, mode="auto")
        p_met = router_m.begin_route(np.arange(16), qemb, budget, mode="auto")
        assert p_free.kind == "jit" and p_free.spec_cost == 0.0
        assert p_met.kind == "reference" and p_met.spec_cost > 0.0
        assert p_met.spec_cost <= budget + 1e-12
        return {"spec": (p_free.spec_cost, p_met.spec_cost), "plan_version": p_met.plan_version,
                "routes": [p_free.result(), p_met.result()]}
    both(scenario)


def test_reference_wave_stepping_resolves_at_stop_wave():
    def scenario(pkg):
        engine, router, qemb = _pool(pkg, B=64)
        _, router2, _ = _pool(pkg, B=64)
        budget = float(engine.costs.sum())
        res = router2.route_batch_reference(np.arange(64), qemb, budget)
        pending = router.begin_route(np.arange(64), qemb, budget, mode="reference")
        seen = np.full(64, -1, np.int64)
        preds = np.full(64, -1, np.int64)
        wave = 0
        while not pending.exhausted:
            rows, p = pending.step()
            assert np.all(seen[rows] == -1)
            seen[rows] = min(wave, pending.T)
            preds[rows] = p
            wave += 1
        assert (seen >= 0).all()
        np.testing.assert_array_equal(seen, res.stop_waves)
        np.testing.assert_array_equal(preds, res.predictions)
        out = pending.result()
        np.testing.assert_array_equal(out.predictions, res.predictions)
        np.testing.assert_allclose(out.costs, res.costs, rtol=1e-12, atol=0)
        np.testing.assert_array_equal(out.invoked, res.invoked)
        return {"seen": seen, "preds": preds, "route": out}
    both(scenario)


def test_stats_consistent_under_interleaved_submits():
    def scenario(pkg):
        engine, router, qemb = _pool(pkg)
        budget = float(np.quantile(engine.costs, 0.6)) * 2
        sched = pkg.BatchScheduler(router, max_batch=24, max_wait_s=0.0)
        futs = [sched.submit(pkg.Request(payload=j, embedding=qemb[j], budget=budget))
                for j in range(20)]
        sched.pump()
        blk = sched.submit_many(np.arange(20, 70), qemb[20:70], budget)
        sched.pump()
        futs += [sched.submit(pkg.Request(payload=j, embedding=qemb[j], budget=budget))
                 for j in range(70, 96)]
        sched.drain()
        st = sched.stats
        assert st["submitted"] == st["requests"] == st["completed"] == 96
        assert all(f.done() for f in futs) and blk.done()
        assert st["batches"] >= st["flushes"] >= 96 // 24
        assert st["inflight_peak"] >= 1
        assert st["spec_jit"] + st["spec_reference"] == st["batches"]
        assert len(sched.mitigator.history) == min(st["batches"], sched.mitigator.window)
        total_waves = sum(f.result().stop_wave for f in futs) + int(blk.stop_waves.sum())
        assert int(sched.arm_query_totals.sum()) == total_waves
        assert st["plan_hits"] + st["plan_misses"] >= st["batches"]
        lat = sched.latency_stats()
        assert lat["count"] == 96 and lat["p99_s"] >= lat["p50_s"]
        return {"results": _results(futs), "blk": blk,
                "totals": sched.arm_query_totals.copy(),
                "mitigator": [h.tobytes() for h in sched.mitigator.history]}
    both(scenario)


def test_empty_block_and_pinned_router_under_auto():
    def scenario(pkg):
        engine, router, qemb = _pool(pkg, B=16)
        budget = float(np.quantile(engine.costs, 0.6)) * 2
        sched = pkg.BatchScheduler(router, max_batch=8, max_wait_s=0.0)
        empty = sched.submit_many(np.zeros((0, 2), np.int64), np.zeros((0, 4)), budget)
        assert empty.done() and empty.n == 0
        assert not sched.ready() and sched.drain() == 0
        blk = sched.submit_many(np.arange(16), qemb, budget)
        sched.drain()
        assert blk.done()
        pinned = pkg.ThriftRouter(engine, router.estimator, num_classes=4, jit_waves=False)
        pending = pinned.begin_route(np.arange(16), qemb, budget, mode="auto")
        assert pending.kind == "reference"
        return {"blk": blk, "route": pending.result()}
    both(scenario)


def test_slo_tightens_admission_deadline():
    for pkg in PACKAGES:
        engine, router, qemb = _pool(pkg, B=8)
        budget = float(np.quantile(engine.costs, 0.6)) * 2
        sched = pkg.BatchScheduler(router, max_batch=64, max_wait_s=60.0, slo_margin_s=0.0)
        sched.submit(pkg.Request(payload=0, embedding=qemb[0], budget=budget))
        assert not sched.ready()
        deadline_no_slo = sched.next_deadline()
        sched.submit(pkg.Request(payload=1, embedding=qemb[1], budget=budget, slo_s=0.0))
        assert sched.next_deadline() < deadline_no_slo
        assert sched.ready()
        assert sched.drain() == 2


def test_queue_composition_prefetch():
    def scenario(pkg):
        engine, router, qemb = _pool(pkg, B=32)
        budget = float(np.quantile(engine.costs, 0.6)) * 2
        sched = pkg.BatchScheduler(router, max_batch=64, max_wait_s=60.0)
        futs = [sched.submit(pkg.Request(payload=j, embedding=qemb[j], budget=budget))
                for j in range(32)]
        assert not sched.ready()
        sched.pump()
        st_mid = dict(router.plans.stats())
        assert st_mid["plan_prefetches"] > 0
        sched.drain()
        assert router.plans.stats()["plan_misses"] == st_mid["plan_misses"]
        assert sched.stats["completed"] == 32
        return {"results": _results(futs), "stats": router.plans.stats()}
    both(scenario)


def test_flush_api_unchanged_and_resolves_futures():
    def scenario(pkg):
        engine, router, qemb = _pool(pkg, B=32)
        budget = float(np.quantile(engine.costs, 0.6)) * 2
        sched = pkg.BatchScheduler(router, max_batch=16, max_wait_s=0.0)
        futs = [sched.submit(pkg.Request(payload=j, embedding=qemb[j], budget=budget))
                for j in range(32)]
        out = sched.flush()
        assert len(out) == 1
        batch, res = out[0]
        assert len(batch) == 16 and all(isinstance(r, pkg.Request) for r in batch)
        assert all(f.done() for f in futs[:16]) and not any(f.done() for f in futs[16:])
        np.testing.assert_array_equal([f.result().prediction for f in futs[:16]],
                                      res.predictions)
        sched.drain()
        assert all(f.done() for f in futs)
        return {"route": res, "results": _results(futs)}
    both(scenario)


def test_kernel_plane_stream_matches_reference():
    """``use_kernel=True`` on both packages: one interleaved-budget stream
    with faults and feedback, through ``drain``. The port's CPU route is
    the plain version of ``belief_aggregate`` and of the grouped mc
    kernel; results equal the reference's except rows within f32
    resolution of the Prop. 4 boundary, which are counted (none here)."""
    out = {}
    for pkg in PACKAGES:
        est, engine, router, qemb, qlab = tabular_pool(pkg, use_kernel=True)
        policy = pkg.FaultPolicy(len(engine.arms), 4, seed=3)
        policy.set_arms(range(len(engine.arms)), timeout=0.05, error=0.03, degrade=0.02)
        engine.fault_policy = policy
        budgets = np.random.default_rng(11).choice(np.quantile(engine.costs, [0.4, 0.8]) * 2.5,
                                                   size=96)
        sched = pkg.BatchScheduler(router, max_batch=32, max_wait_s=0.0, feedback=True)
        blk = sched.submit_many(np.arange(96), qemb, budgets)
        sched.drain()
        sched.record_outcomes(blk.request_ids, qlab)
        blk2 = sched.submit_many(np.arange(96), qemb, budgets[::-1].copy())
        sched.drain()
        out[pkg.name] = (blk, blk2, dict(sched.stats))
    near = 0
    for got, want in zip(out["port"][:2], out["ref"][:2]):
        differ = (got.predictions != want.predictions) | (got.stop_waves != want.stop_waves)
        near += int(differ.sum())
        same = ~differ
        np.testing.assert_array_equal(got.costs[same], want.costs[same])
        np.testing.assert_array_equal(got.modes, want.modes)
    assert near == 0
    for got, want in zip(out["port"][:2], out["ref"][:2]):
        assert_blocks_equal(got, want)
    got_st, want_st = out["port"][2], out["ref"][2]
    assert got_st == {k: want_st[k] for k in got_st}
    assert got_st["degradation_failures"] > 0
