"""The port's PlanService against the JAX package's: ``tests/test_plans.py``'s
scenarios (all but ``prewarm_compile``, which has no counterpart in an
eagerly run port) on both packages from the same seeds.

Each scenario asserts the reference's own contract — hit/miss accounting,
prewarm ahead of traffic and after a cost invalidation, hot-pair tracking,
lazy per-cluster invalidation, the bounded selector memo, batched plan
builds and drift replans — on both packages, and the port's plans and
counters equal the reference's bitwise.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):      # removed in jax 0.9
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np

from _torch_serving import (
    both,
    one_torch_thread,  # noqa: F401  (autouse: torch on one CPU thread)
    plan_state,
    tabular_pool,
)


def _make(pkg, B=64, **kw):
    est, engine, router, qemb, _ = tabular_pool(pkg, B=B, **kw)
    return est, engine, router, qemb


def _budget(engine, q=0.6):
    return float(np.quantile(engine.costs, q)) * 2


def _plans(router, est, budget):
    return [plan_state(router.plans.plan(int(c), budget)) for c in est.cluster_order]


def test_plan_cache_hits_and_misses():
    def scenario(pkg):
        est, engine, router, qemb = _make(pkg)
        budget, B = _budget(engine), qemb.shape[0]
        r1 = router.route_batch(np.arange(B), qemb, budget)
        s1 = router.plans.stats()
        assert s1["plan_misses"] > 0 and s1["plan_misses"] == s1["plan_cache_size"]
        r2 = router.route_batch(np.arange(B), qemb, budget)
        s2 = router.plans.stats()
        assert s2["plan_misses"] == s1["plan_misses"] and s2["plan_hits"] > s1["plan_hits"]
        assert s2["plan_cache_size"] == s1["plan_cache_size"]
        return {"routes": [r1, r2], "stats": s2}
    both(scenario)


def test_prewarm_ahead_of_traffic_and_hot_pairs():
    def scenario(pkg):
        est, engine, router, qemb = _make(pkg)
        budget = _budget(engine)
        assert router.plans.prewarm(budgets=[budget]) == len(est.clusters)
        router.route_batch(np.arange(qemb.shape[0]), qemb, budget)
        s = router.plans.stats()
        assert s["plan_misses"] == 0 and s["plan_hits"] > 0
        hot = router.plans.hot_pairs(3)
        assert hot and all(b == budget for _, b in hot)
        assert router.plans.prewarm(pairs=[(hot[0][0], budget * 1.5)]) == 1
        return {"hot": hot, "stats": router.plans.stats(), "plans": _plans(router, est, budget)}
    both(scenario)


def test_invalidation_on_pool_change():
    def scenario(pkg):
        est, engine, router, qemb = _make(pkg)
        budget, B = _budget(engine), qemb.shape[0]
        before = router.route_batch(np.arange(B), qemb, budget)
        assert router.plans.stats()["plan_cache_size"] > 0
        cheap = int(np.argmin(engine.costs))
        engine.arms[cheap].cost = budget * 10.0
        after = router.route_batch(np.arange(B), qemb, budget)
        s = router.plans.stats()
        assert s["plan_invalidations"] == 1 and s["plan_cache_size"] > 0
        assert all(cheap not in used for used in after.arms_used)
        assert any(cheap in used for used in before.arms_used)
        assert (after.costs <= budget + 1e-12).all()
        router.route_batch(np.arange(B), qemb, budget)
        assert router.plans.stats()["plan_invalidations"] == 1
        return {"routes": [before, after], "stats": router.plans.stats()}
    both(scenario)


def test_prewarm_hot_pairs_survive_cost_invalidation():
    def scenario(pkg):
        est, engine, router, qemb = _make(pkg)
        budget, B = _budget(engine), qemb.shape[0]
        router.route_batch(np.arange(B), qemb, budget)
        hot = set(router.plans.hot_pairs(16))
        assert hot
        engine.arms[0].cost = engine.arms[0].cost * 3.0
        assert router.plans.prewarm() == len(hot)
        assert router.plans.stats()["plan_invalidations"] == 1
        before = router.plans.stats()["plan_misses"]
        router.route_batch(np.arange(B), qemb, budget)
        assert router.plans.stats()["plan_misses"] == before
        return {"hot": sorted(hot), "stats": router.plans.stats()}
    both(scenario)


def test_single_cluster_update_keeps_other_plans():
    def scenario(pkg):
        est, engine, router, qemb = _make(pkg)
        budget, B = _budget(engine), qemb.shape[0]
        router.route_batch(np.arange(B), qemb, budget)
        misses_before = router.plans.stats()["plan_misses"]
        est.update(int(next(iter(est.clusters))), np.ones((4, len(engine.arms))))
        res = router.route_batch(np.arange(B), qemb, budget)
        s = router.plans.stats()
        assert s["plan_invalidations"] == 1 and s["plan_misses"] == misses_before + 1
        return {"route": res, "stats": s}
    both(scenario)


def test_hot_pairs_track_traffic_through_fast_path():
    def scenario(pkg):
        est, engine, router, qemb = _make(pkg)
        budget, B = _budget(engine), qemb.shape[0]
        for _ in range(3):
            router.route_batch(np.arange(B), qemb, budget)
        counts = router.plans._pair_counts
        assert sum(counts.values()) >= 3 * B
        top_cluster = router.plans.hot_pairs(1)[0][0]
        idx = est.lookup_batch_indices(qemb)
        assert top_cluster == int(est.cluster_order[np.argmax(np.bincount(idx))])
        return {"counts": dict(counts), "hot": router.plans.hot_pairs(16),
                "known": router.plans.known_budgets()}
    both(scenario)


def test_shared_plan_service_across_routers():
    def scenario(pkg):
        est, engine, router, qemb = _make(pkg)
        budget, B = _budget(engine), qemb.shape[0]
        router.route_batch(np.arange(B), qemb, budget)
        misses = router.plans.stats()["plan_misses"]
        router2 = pkg.ThriftRouter(engine, est, num_classes=4, plan_service=router.plans)
        res = router2.route_batch(np.arange(B), qemb, budget)
        assert router.plans.stats()["plan_misses"] == misses
        return {"route": res, "stats": router.plans.stats()}
    both(scenario)


def test_out_of_band_p_hat_edit_needs_touch():
    def scenario(pkg):
        est, engine, router, qemb = _make(pkg)
        budget = _budget(engine)
        cid = int(est.cluster_order[0])
        p0 = router.plans.plan(cid, budget)
        est.clusters[cid].p_hat = np.clip(est.clusters[cid].p_hat * 0.5, 0, 1)
        est.touch(cid)
        p1 = router.plans.plan(cid, budget)
        assert p1 is not p0
        assert router.plans.refresh() is True
        assert router.plans.plan(cid, budget) is p1
        # touch re-snapshots the drift detector's plan-visible estimate
        np.testing.assert_array_equal(est.clusters[cid].plan_p_hat, est.clusters[cid].p_hat)
        return {"plan": plan_state(p1), "stats": router.plans.stats()}
    both(scenario)


def test_selector_cache_bounded_under_estimate_churn():
    def scenario(pkg):
        est, engine, router, qemb = _make(pkg)
        budget = _budget(engine)
        cid = int(est.cluster_order[0])
        rng = np.random.default_rng(0)
        for _ in range(3):
            est.update(cid, (rng.random((2, len(engine.arms))) < 0.7).astype(float))
            router.plans.refresh()
            router.plans.plan(cid, budget)
        sel = router.selector
        sel._cache.update({("pad", i): i for i in range(400)})
        over = len(sel._cache)
        cap = max(128, 4 * len(router.plans._cache))
        est.update(cid, np.ones((2, len(engine.arms))))
        router.plans.refresh()
        assert len(sel._cache) == cap < over
        assert ("pad", 399) in sel._cache
        return {"size": len(sel._cache), "stats": router.plans.stats()}
    both(scenario)


def test_scheduler_exposes_plan_stats_and_prewarm():
    def scenario(pkg):
        est, engine, router, qemb = _make(pkg, B=16)
        budget = _budget(engine)
        sched = pkg.BatchScheduler(router, max_batch=16, max_wait_s=0.0)
        assert "plan_hits" in sched.stats and "plan_misses" in sched.stats
        built = sched.prewarm(budgets=[budget])
        assert built == len(est.clusters)
        for i in range(16):
            sched.submit(pkg.Request(payload=i, embedding=qemb[i], budget=budget))
        (_, res), = sched.flush()
        assert sched.stats["plan_misses"] == 0 and sched.stats["plan_hits"] > 0
        assert sched.stats["plan_cache_size"] >= built
        return {"route": res, "stats_sched": {k: v for k, v in sched.stats.items()
                                              if k.startswith("plan_")}}
    both(scenario)


def test_plan_many_matches_plan_and_counts():
    def scenario(pkg):
        est, engine, router, _ = _make(pkg)
        _, _, router2, _ = _make(pkg)
        budget = _budget(engine)
        pairs = [(int(c), budget) for c in est.cluster_order]
        serial = [router.plans.plan(c, b) for c, b in pairs]
        batched = router2.plans.plan_many(pairs)
        for s, m in zip(serial, batched):
            assert plan_state(s) == plan_state(m)
        assert router.plans.stats() == router2.plans.stats()
        again = router2.plans.plan_many(pairs)
        assert all(a is b for a, b in zip(again, batched))
        assert router2.plans.stats()["plan_misses"] == len(pairs)
        return {"plans": [plan_state(p) for p in batched], "stats": router2.plans.stats()}
    both(scenario)


def test_serial_and_batched_services_build_identical_plans():
    def scenario(pkg):
        est, engine, router, _ = _make(pkg)
        _, _, router2, _ = _make(pkg)
        router2.plans.batched = False
        budget = _budget(engine, 0.5)
        pairs = [(int(c), budget) for c in est.cluster_order]
        batched, serial = router.plans.plan_many(pairs), router2.plans.plan_many(pairs)
        for pb, ps in zip(batched, serial):
            np.testing.assert_array_equal(pb.order, ps.order)
            np.testing.assert_array_equal(pb.weights, ps.weights)
        return {"plans": [plan_state(p) for p in serial]}
    both(scenario)


def test_replan_stale_rebuilds_dropped_pairs_in_one_call():
    def scenario(pkg):
        est, engine, router, _ = _make(pkg)
        plans = router.plans
        budget = _budget(engine)
        plans.plan_many([(int(c), budget) for c in est.cluster_order])
        size0 = len(plans._cache)
        drifted = [int(c) for c in est.cluster_order[:3]]
        for c in drifted:
            est.touch(c)
        assert plans.replan_stale(drifted) == 3
        assert len(plans._cache) == size0
        s = plans.stats()
        assert s["plan_batch_replans"] == 1 and s["plan_batch_replanned"] == 3
        assert s["plan_stale_dropped"] == 3
        before = plans.stats()["plan_misses"]
        for c in drifted:
            plans.plan(c, budget)
        assert plans.stats()["plan_misses"] == before
        return {"plans": _plans(router, est, budget), "stats": plans.stats()}
    both(scenario)


def test_prefetch_for_builds_queued_pairs_as_prefetches():
    def scenario(pkg):
        est, engine, router, qemb = _make(pkg)
        budget = _budget(engine)
        budgets = np.where(np.arange(qemb.shape[0]) % 3 == 0, budget, budget * 1.7)
        built = router.plans.prefetch_for(qemb, budgets)
        s = router.plans.stats()
        assert built > 0 and s["plan_prefetches"] == built and s["plan_misses"] == 0
        assert router.plans.prefetch_for(qemb, budgets) == 0
        return {"built": built, "stats": router.plans.stats()}
    both(scenario)
