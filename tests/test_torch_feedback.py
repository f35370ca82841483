"""The port's online feedback loop against the JAX package's:
``tests/test_feedback.py``'s scenarios run on both packages from the same
seeds.

Each case asserts the reference's own contract on the port — zero labels
change nothing, confirming feedback keeps plans hot, stale version keys
never serve, drift replans only the drifted clusters (batched, at
admission), the online loop recovers the oracle's accuracy where frozen
plans do not, probes feed unplanned arms, the FeedbackLog's retention and
id authority — and that the port's per-request results, feedback counters
and estimator states equal the reference's bitwise. Feedback shards merge
exactly on the port.
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
    estimator_state,
    one_torch_thread,  # noqa: F401  (autouse: torch on one CPU thread)
    oracle_pool,
    tabular_pool,
)


def _equal_runs(seen, keys=None):
    """The port's recorded values equal the reference's: stats dicts on
    the port's keys, blocks column by column, everything else by ==."""
    got, want = seen["port"], seen["ref"]
    assert got.keys() == want.keys()
    for k in got:
        g, w = got[k], want[k]
        if isinstance(g, dict) and isinstance(w, dict) and k.startswith("stats"):
            assert g == {s: w[s] for s in g}, k
        elif isinstance(g, list) and g and hasattr(g[0], "predictions"):
            for a, b in zip(g, w):
                assert_blocks_equal(a, b, k)
        elif hasattr(g, "predictions"):
            assert_blocks_equal(g, w, k)
        else:
            assert g == w, k


def test_zero_labels_is_bit_identical_and_no_hit_rate_regression():
    seen = {}
    for pkg in PACKAGES:
        est_a, engine, router_a, qemb, _ = tabular_pool(pkg, B=96)
        est_b, _, router_b, _, _ = tabular_pool(pkg, B=96)
        budgets = np.random.default_rng(11).choice(np.quantile(engine.costs, [0.4, 0.8]) * 2.5,
                                                   size=96)
        sched_fb = pkg.BatchScheduler(router_a, max_batch=32, max_wait_s=0.0, feedback=True)
        sched_off = pkg.BatchScheduler(router_b, max_batch=32, max_wait_s=0.0)
        blk_fb = sched_fb.submit_many(np.arange(96), qemb, budgets)
        blk_off = sched_off.submit_many(np.arange(96), qemb, budgets)
        sched_fb.drain()
        sched_off.drain()
        np.testing.assert_array_equal(blk_fb.predictions, blk_off.predictions)
        np.testing.assert_allclose(blk_fb.costs, blk_off.costs, rtol=1e-15, atol=0)
        np.testing.assert_array_equal(blk_fb.stop_waves, blk_off.stop_waves)
        for key in ("plan_hits", "plan_misses", "plan_invalidations", "plan_stale_dropped"):
            assert sched_fb.stats[key] == sched_off.stats[key], key
        assert est_a.version == 0 and est_a.plan_version == 0
        assert sched_fb.stats["feedback_labels"] == 0
        assert sched_fb.stats["feedback_watching"] == 96
        assert sched_fb.apply_feedback() is None
        seen[pkg.name] = {"blk": blk_fb, "stats": dict(sched_fb.stats)}
    _equal_runs(seen)


def test_continuous_with_feedback_matches_oneshot_stream():
    seen = {}
    for pkg in PACKAGES:
        est, engine, router, qemb, _ = tabular_pool(pkg, B=64)
        _, _, router2, _, _ = tabular_pool(pkg, B=64)
        budget = float(np.quantile(engine.costs, 0.6)) * 2
        sched = pkg.BatchScheduler(router, max_batch=16, max_wait_s=0.0, feedback=True)
        futs = [sched.submit(pkg.Request(payload=j, embedding=qemb[j], budget=budget))
                for j in range(64)]
        sched.drain()
        preds, costs = np.zeros(64, np.int64), np.zeros(64, np.float64)
        for s in range(0, 64, 16):
            rows = np.arange(s, s + 16)
            res = router2.route_batch(rows, qemb[rows], budget)
            preds[rows], costs[rows] = res.predictions, res.costs
        np.testing.assert_array_equal([f.result().prediction for f in futs], preds)
        np.testing.assert_allclose([f.result().cost for f in futs], costs, rtol=1e-15, atol=0)
        assert [f.request_id for f in futs] == list(range(64))
        assert all(f.result().request_id == f.request_id for f in futs)
        seen[pkg.name] = {"results": [(r.prediction, r.cost, r.planned_cost, r.cluster,
                                       r.stop_wave, r.mode, r.request_id)
                                      for r in (f.result() for f in futs)]}
    _equal_runs(seen)


def test_confirming_feedback_keeps_plans_hot():
    seen = {}
    for pkg in PACKAGES:
        wl, est, engine, router = oracle_pool(pkg)
        budget = float(np.quantile(engine.costs, 0.5)) * 2
        sched = pkg.BatchScheduler(router, max_batch=128, max_wait_s=0.0, feedback=True)
        rng = np.random.default_rng(7)
        cid, qemb, lab = wl.sample_queries(256, rng)
        b1 = sched.submit_many(np.column_stack([cid, lab]), qemb, budget)
        sched.drain()
        misses0 = sched.stats["plan_misses"]
        sched.record_outcomes(b1.request_ids, lab)
        cid, qemb, lab = wl.sample_queries(256, rng)
        b2 = sched.submit_many(np.column_stack([cid, lab]), qemb, budget)
        sched.drain()
        st = dict(sched.stats)
        assert st["feedback_applies"] == 1 and st["feedback_drifts"] == 0
        assert est.version > 0 and est.plan_version == 0
        assert all(c.version == 0 for c in est.clusters.values())
        assert st["plan_misses"] == misses0 and st["plan_stale_dropped"] == 0
        seen[pkg.name] = {"blocks": [b1, b2], "stats": st, "est": estimator_state(est)}
    _equal_runs(seen)


def test_stale_version_keys_never_serve_without_refresh():
    seen = {}
    for pkg in PACKAGES:
        _, est, engine, router = oracle_pool(pkg)
        plans = router.plans
        budget = float(np.quantile(engine.costs, 0.5)) * 2
        cid = int(est.cluster_order[0])
        p0, t0 = plans.plan(cid, budget), plans.batch_tables(budget)
        assert plans.plan(cid, budget) is p0 and plans.batch_tables(budget) is t0
        size0 = len(plans._cache)
        est.update(cid, np.ones((40, len(engine.arms))))
        p1, t1 = plans.plan(cid, budget), plans.batch_tables(budget)
        assert p1 is not p0 and t1 is not t0
        assert (not np.array_equal(p1.weights, p0.weights)
                or not np.array_equal(p1.order, p0.order))
        assert len(plans._cache) == size0 + 1
        assert plans.refresh() is True
        assert len(plans._cache) == size0
        assert plans.stats()["plan_stale_dropped"] == 1
        assert plans.plan(cid, budget) is p1
        seen[pkg.name] = {"order": p1.order.tolist(), "weights": p1.weights.tobytes(),
                          "stats": plans.stats()}
    _equal_runs(seen)


def test_drift_replans_only_drifted_clusters():
    seen = {}
    for pkg in PACKAGES:
        wl, est, engine, router = oracle_pool(pkg)
        budget = float(np.quantile(engine.costs, 0.5)) * 2
        sched = pkg.BatchScheduler(router, max_batch=256, max_wait_s=0.0, feedback=True)
        rng = np.random.default_rng(5)
        target = 0
        plan_arms = router.plans.plan(target, budget).order
        wl.drift_arms(plan_arms, 0.30, clusters=[target])
        drifted, blocks = False, []
        for _ in range(4):
            cid, qemb, lab = wl.sample_queries(256, rng)
            blk = sched.submit_many(np.column_stack([cid, lab]), qemb, budget)
            sched.drain()
            sched.record_outcomes(blk.request_ids, lab)
            drifted |= bool(sched.stats["feedback_drifts"])
            blocks.append(blk)
        sched.apply_feedback()
        assert drifted or sched.stats["feedback_drifts"] > 0
        assert est.clusters[target].version > 0
        assert all(est.clusters[c].version == 0 for c in est.clusters if c != target)
        new_plan = router.plans.plan(target, budget)
        assert not np.array_equal(np.sort(new_plan.order), np.sort(plan_arms))
        assert sched.stats["plan_stale_dropped"] >= 1
        seen[pkg.name] = {"blocks": blocks, "stats": dict(sched.stats),
                          "est": estimator_state(est), "order": new_plan.order.tolist()}
    _equal_runs(seen)


def test_online_feedback_recovers_oracle_accuracy_frozen_does_not():
    """The acceptance bar, on both packages: >= 90% of the oracle-replan
    accuracy on the drifted clusters' tail traffic with feedback, below it
    frozen; the port's accuracies are the reference's exactly."""
    seen = {}
    for pkg in PACKAGES:
        wl, est, engine, router = oracle_pool(pkg)
        K, L = 4, len(engine.arms)
        budget = float(np.quantile(engine.costs, 0.5)) * 2
        sched = pkg.BatchScheduler(router, max_batch=256, max_wait_s=0.0, feedback=True)
        targets = [0, 1]
        for t in targets:
            wl.drift_arms(router.plans.plan(t, budget).order, 0.30, clusters=[t])
        T2, emb2, cid2 = wl.response_table(120 * est.cluster_order.size, seed=14)
        oracle = pkg.ThriftRouter(
            pkg.PoolEngine([pkg.OracleArm(f"o{i}", wl, i, seed=12) for i in range(L)]),
            pkg.SuccessProbEstimator(T2, emb2, cid2), num_classes=K)
        wl_f, _, _, frozen = oracle_pool(pkg, arm_seed=13)
        wl_f.p_true[:] = wl.p_true
        rng = np.random.default_rng(5)
        accs, oaccs, faccs = [], [], []
        for _ in range(14):
            cid, qemb, lab = wl.sample_queries(256, rng)
            m = np.isin(cid, targets)
            q = np.column_stack([cid, lab])
            blk = sched.submit_many(q, qemb, budget)
            sched.drain()
            ores = oracle.route_batch(q, qemb, budget)
            fres = frozen.route_batch(q, qemb, budget)
            accs.append(float((blk.predictions[m] == lab[m]).mean()))
            oaccs.append(float((ores.predictions[m] == lab[m]).mean()))
            faccs.append(float((fres.predictions[m] == lab[m]).mean()))
            sched.record_outcomes(blk.request_ids, lab)
        online, oracle_acc, frozen_acc = (float(np.mean(a[7:])) for a in (accs, oaccs, faccs))
        assert online >= 0.9 * oracle_acc, (online, oracle_acc, accs)
        assert frozen_acc < 0.9 * oracle_acc, (frozen_acc, oracle_acc, faccs)
        st = dict(sched.stats)
        assert st["feedback_drifts"] >= 1 and st["plan_stale_dropped"] >= 1
        seen[pkg.name] = {"accs": (accs, oaccs, faccs), "stats": st, "est": estimator_state(est)}
    _equal_runs(seen)


def test_feedback_log_unmatched_eviction_and_shared_use():
    seen = {}
    for pkg in PACKAGES:
        _, est, engine, router = oracle_pool(pkg)
        log = pkg.FeedbackLog(est, max_watch=4)
        sched = pkg.BatchScheduler(router, max_batch=8, max_wait_s=0.0, feedback=log)
        assert sched.feedback is log
        assert log.record(999, 0) is False
        assert log.stats()["feedback_unmatched"] == 1
        wl = engine.arms[0].workload
        cid, qemb, lab = wl.sample_queries(8, np.random.default_rng(1))
        budget = float(np.quantile(engine.costs, 0.5)) * 2
        blk = sched.submit_many(np.column_stack([cid, lab]), qemb, budget)
        sched.drain()
        assert log.watching == 4 and log.stats()["feedback_evicted"] == 4
        assert log.record(int(blk.request_ids[0]), int(lab[0])) is False
        assert log.record(int(blk.request_ids[-1]), int(lab[-1])) is True
        assert log.record(int(blk.request_ids[-1]), int(lab[-1])) is False
        assert log.pending == 1
        report = log.apply()
        assert report.labels == 1 and report.version == est.version and log.pending == 0
        seen[pkg.name] = {"blk": blk, "stats": log.stats(), "est": estimator_state(est),
                          "report": (report.labels, report.clusters, report.drifted,
                                     report.version)}
    _equal_runs(seen)


def test_shared_log_ids_unique_and_labeled_ids_age_out():
    seen = {}
    for pkg in PACKAGES:
        _, est, engine, router = oracle_pool(pkg)
        _, _, _, router2 = oracle_pool(pkg, arm_seed=17)
        log = pkg.FeedbackLog(est, max_watch=64)
        s1 = pkg.BatchScheduler(router, max_batch=8, max_wait_s=0.0, feedback=log)
        s2 = pkg.BatchScheduler(router2, max_batch=8, max_wait_s=0.0, feedback=log)
        wl = engine.arms[0].workload
        rng = np.random.default_rng(2)
        budget = float(np.quantile(engine.costs, 0.5)) * 2
        cid, qemb, lab = wl.sample_queries(8, rng)
        q = np.column_stack([cid, lab])
        b1 = s1.submit_many(q, qemb, budget)
        s1.drain()
        b2 = s2.submit_many(q, qemb, budget)
        s2.drain()
        assert not set(b1.request_ids.tolist()) & set(b2.request_ids.tolist())
        assert s1.record_outcomes(b1.request_ids, lab) == 8
        assert s2.record_outcomes(b2.request_ids, lab) == 8
        assert log.stats()["feedback_unmatched"] == 0
        blocks = [b1, b2]
        for _ in range(20):
            cid, qemb, lab = wl.sample_queries(8, rng)
            blk = s1.submit_many(np.column_stack([cid, lab]), qemb, budget)
            s1.drain()
            s1.record_outcomes(blk.request_ids, lab)
            blocks.append(blk)
        assert len(log._watch_order) <= 64
        assert log.watching == 0 and not log._blocks
        seen[pkg.name] = {"blocks": blocks, "stats": log.stats(), "est": estimator_state(est)}
    _equal_runs(seen)


def test_probe_rate_zero_changes_nothing():
    seen = {}
    for pkg in PACKAGES:
        wl, est, engine, router = oracle_pool(pkg)
        _, est2, _, router2 = oracle_pool(pkg)
        budget = float(np.quantile(engine.costs, 0.5)) * 2
        s_a = pkg.BatchScheduler(router, max_batch=64, max_wait_s=0.0,
                                 feedback=pkg.FeedbackLog(est))
        s_b = pkg.BatchScheduler(router2, max_batch=64, max_wait_s=0.0,
                                 feedback=pkg.FeedbackLog(est2, probe_rate=0.0))
        cid, qemb, lab = wl.sample_queries(64, np.random.default_rng(8))
        q = np.column_stack([cid, lab])
        a = s_a.submit_many(q, qemb, budget)
        s_a.drain()
        b = s_b.submit_many(q, qemb, budget)
        s_b.drain()
        np.testing.assert_array_equal(a.predictions, b.predictions)
        assert s_b.stats["feedback_probes"] == 0
        seen[pkg.name] = {"blk": b}
    _equal_runs(seen)


def test_probes_feed_unplanned_arm_estimates():
    seen = {}
    for pkg in PACKAGES:
        wl, est, engine, router = oracle_pool(pkg)
        budget = float(np.quantile(engine.costs, 0.5)) * 2
        log = pkg.FeedbackLog(est, probe_rate=1.0, probe_seed=5)
        sched = pkg.BatchScheduler(router, max_batch=64, max_wait_s=0.0, feedback=log)
        cid, qemb, lab = wl.sample_queries(64, np.random.default_rng(9))
        blk = sched.submit_many(np.column_stack([cid, lab]), qemb, budget)
        sched.drain()
        assert log.probes == 64
        planned = {(int(c), int(a)) for c in np.unique(cid)
                   for a in router.plans.plan(int(c), budget).order}
        before = {int(c): est.clusters[int(c)].arm_counts.copy() for c in np.unique(cid)}
        sched.record_outcomes(blk.request_ids, lab)
        report = sched.apply_feedback()
        assert report is not None and report.labels == 64
        moved_unplanned = sum(
            (int(c), int(a)) not in planned
            for c in np.unique(cid)
            for a in np.flatnonzero(est.clusters[int(c)].arm_counts - before[int(c)] > 0))
        assert moved_unplanned > 0
        seen[pkg.name] = {"blk": blk, "stats": dict(sched.stats), "est": estimator_state(est)}
    _equal_runs(seen)


def test_drift_replans_are_batched_at_admission():
    seen = {}
    for pkg in PACKAGES:
        wl, est, engine, router = oracle_pool(pkg)
        budget = float(np.quantile(engine.costs, 0.5)) * 2
        sched = pkg.BatchScheduler(router, max_batch=256, max_wait_s=0.0, feedback=True)
        rng = np.random.default_rng(5)
        targets = [0, 1]
        for t in targets:
            wl.drift_arms(router.plans.plan(t, budget).order, 0.30, clusters=[t])
        for _ in range(4):
            cid, qemb, lab = wl.sample_queries(256, rng)
            blk = sched.submit_many(np.column_stack([cid, lab]), qemb, budget)
            sched.drain()
            sched.record_outcomes(blk.request_ids, lab)
        sched.apply_feedback()
        st = dict(sched.stats)
        assert st["feedback_drifts"] >= 1 and st["plan_batch_replans"] >= 1
        assert st["plan_batch_replanned"] >= st["feedback_drifts"] >= 1
        misses = router.plans.stats()["plan_misses"]
        for t in targets:
            router.plans.plan(t, budget)
        assert router.plans.stats()["plan_misses"] == misses
        seen[pkg.name] = {"stats": st, "est": estimator_state(est)}
    _equal_runs(seen)


def test_wilson_interval_matches_reference():
    from _torch_serving import REF

    rng = np.random.default_rng(3)
    p = rng.uniform(0, 1, 40)
    for n in (rng.integers(0, 50, 40).astype(np.float64), 0.0, 17.0):
        for delta in (0.05, 0.01):
            for got, want in zip(PORT.wilson_interval(p, n, delta),
                                 REF.wilson_interval(p, n, delta)):
                np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("parts", [1, 2, 3])
def test_feedback_shards_merge_exactly(parts):
    """Any split of one label stream into shards, merged (in any order),
    folds to the single-log estimator state; export drains, absorb adds."""
    def run(split):
        _, est, engine, router = oracle_pool(PORT)
        budget = float(np.quantile(engine.costs, 0.5)) * 2
        logs = [PORT.FeedbackLog(est) for _ in range(split)]
        wl = engine.arms[0].workload
        cid, qemb, lab = wl.sample_queries(120, np.random.default_rng(6))
        res = router.route_batch(np.column_stack([cid, lab]), qemb, budget)
        ids = np.arange(120)
        for i, log in enumerate(logs):
            rows = ids[i::split]
            log.observe(ids[rows], res.clusters[rows], res.schedule[rows],
                        res.responses[rows], res.invoked[rows])
            assert log.record_many(ids[rows], lab[rows]) == rows.size
        shards = [log.export_shard() for log in logs]
        assert all(log.pending == 0 and not log.has_pending for log in logs)
        merged = PORT.merge_counts(*shards[::-1])
        assert merged.labels == 120
        logs[0].absorb_shard(merged)
        report = logs[0].apply()
        return estimator_state(est), report.labels, report.drifted
    assert run(parts) == run(1)
