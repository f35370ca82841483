"""The port's R-replica serving plane against the JAX package's:
``tests/test_replica.py``'s cases on both packages from the same seeds.

Each case asserts the reference's own contract on both packages — R=1 is
bit-identical to a ``BatchScheduler`` (blocks and single requests), fused
R=4 and pump-driven mixed-budget R=2 streams equal one baseline scheduler
per request, cluster affinity is sticky and spills cap skew (counted once,
never back home), shard-merged feedback leaves the single-log estimator
state, stray labels land on the central log, a faulted R=3 stream keeps
the ledger invariant, tenant rejections match the baseline — and that the
port's blocks (predictions, costs, planned costs, clusters, budgets, stop
waves, modes, request ids), every stats key, arm totals, ledger snapshots
and estimator states equal the reference's bitwise.

No counterpart: ``test_replica_stream_zero_recompiles_after_prewarm`` —
the port runs eagerly, with no wave programs to compile, so it has no
``prewarm_compile`` and no compile sentinel.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):      # removed in jax 0.9
    jax.experimental.enable_x64 = jax.enable_x64

import json

import numpy as np

from _torch_serving import (
    assert_blocks_equal,
    both,
    estimator_state,
    make_pool,
    one_torch_thread,  # noqa: F401  (autouse: torch on one CPU thread)
    pool_budget,
)


def _ledger_state(led):
    return json.dumps(led.snapshot(), sort_keys=True)


def test_r1_bit_identical_to_batch_scheduler():
    """ReplicaSet(replicas=1) IS a BatchScheduler: same outputs, same
    feedback folds (probe rng stream included), same ledger settlement,
    same stats counters on a 3-block multi-tenant stream with mid-stream
    label folds."""
    def scenario(pkg):
        engine_a, router_a, qemb, qlab = make_pool(pkg)
        engine_b, router_b, _, _ = make_pool(pkg)
        budget = pool_budget(engine_a)
        B = qemb.shape[0]
        tenants = np.asarray(["acme", "zen", "acme"], object)

        def led():
            ledger = pkg.CostLedger(num_arms=len(engine_a.arms))
            ledger.set_limit("acme", budget * B)
            ledger.set_limit("zen", budget * B)
            return ledger

        rset = pkg.ReplicaSet(
            router_a, replicas=1, max_batch=16, max_wait_s=0.0,
            feedback=pkg.FeedbackLog(router_a.estimator, probe_rate=0.2, probe_seed=5),
            ledger=led(),
        )
        base = pkg.BatchScheduler(
            router_b, max_batch=16, max_wait_s=0.0,
            feedback=pkg.FeedbackLog(router_b.estimator, probe_rate=0.2, probe_seed=5),
            ledger=led(),
        )
        assert rset.fuse_waves is False and rset.placement == "inline"
        cuts = [(0, 32), (32, 64), (64, B)]
        first = {"rset": [], "base": []}
        for name, sched in (("rset", rset), ("base", base)):
            for k, (s, e) in enumerate(cuts):
                blk = sched.submit_many(np.arange(s, e), qemb[s:e], budget, tenant=tenants[k])
                sched.drain()
                sched.record_outcomes(blk.request_ids, qlab[s:e])
                first[name].append(blk)
                if k == len(cuts) - 1:
                    sched.apply_feedback()
        second = {"rset": [], "base": []}
        for name, sched in (("rset", rset), ("base", base)):
            for s, e in cuts:
                second[name].append(sched.submit_many(np.arange(s, e), qemb[s:e], budget))
            sched.drain()
        for a, b in zip(first["rset"] + second["rset"], first["base"] + second["base"]):
            assert_blocks_equal(a, b)
        np.testing.assert_array_equal(rset.arm_query_totals, base.arm_query_totals)
        rstats = rset.stats
        for k, v in base.stats.items():                # rset adds replica_* keys
            assert rstats[k] == v, f"stats[{k}]: replica {rstats[k]} != base {v}"
        assert rstats["replicas"] == 1
        assert rstats["replica_fused"] == 0 and rstats["replica_spills"] == 0
        assert rset.latency_stats()["count"] == base.latency_stats()["count"]
        assert _ledger_state(rset.ledger) == _ledger_state(base.ledger)
        return {"blocks": first["rset"] + second["rset"], "replica_stats": rstats,
                "totals": rset.arm_query_totals, "ledger": _ledger_state(rset.ledger),
                "estimator": estimator_state(router_a.estimator)}
    both(scenario)


def test_r1_submit_single_requests_match():
    def scenario(pkg):
        engine_a, router_a, qemb, _ = make_pool(pkg, B=48)
        engine_b, router_b, _, _ = make_pool(pkg, B=48)
        budget = pool_budget(engine_a)
        rset = pkg.ReplicaSet(router_a, replicas=1, max_batch=16, max_wait_s=0.0)
        base = pkg.BatchScheduler(router_b, max_batch=16, max_wait_s=0.0)
        fa = [rset.submit(pkg.Request(payload=j, embedding=qemb[j], budget=budget))
              for j in range(48)]
        fb = [base.submit(pkg.Request(payload=j, embedding=qemb[j], budget=budget))
              for j in range(48)]
        rset.drain()
        base.drain()
        out = []
        for x, y in zip(fa, fb):
            rx, ry = x.result(), y.result()
            got = (rx.prediction, rx.cost, rx.stop_wave, rx.mode, rx.request_id)
            assert got == (ry.prediction, ry.cost, ry.stop_wave, ry.mode, ry.request_id)
            out.append(got)
        return {"results": out}
    both(scenario)


def test_r4_fused_matches_baseline_per_request():
    """On a fault-free deterministic pool, per-query routing does not
    depend on which rows share a wave program: the fused R=4 outputs equal
    a single baseline scheduler's, row for row."""
    def scenario(pkg):
        engine_a, router_a, qemb, _ = make_pool(pkg)
        engine_b, router_b, _, _ = make_pool(pkg)
        budget = pool_budget(engine_a)
        B = qemb.shape[0]
        rset = pkg.ReplicaSet(router_a, replicas=4, max_batch=16, max_wait_s=0.0)
        assert rset.fuse_waves is True              # one device on both packages
        blk = rset.submit_many(np.arange(B), qemb, budget)
        rset.drain()
        base = pkg.BatchScheduler(router_b, max_batch=B, max_wait_s=0.0)
        ref = base.submit_many(np.arange(B), qemb, budget)
        base.drain()
        for f in ("predictions", "costs", "stop_waves"):
            np.testing.assert_array_equal(getattr(blk, f), getattr(ref, f))
        np.testing.assert_array_equal(rset.arm_query_totals, base.arm_query_totals)
        st = rset.stats
        assert st["completed"] == B
        assert st["replica_fused"] >= 1 and st["replica_fused_rows"] <= B
        return {"blocks": [blk], "replica_stats": st, "totals": rset.arm_query_totals}
    both(scenario)


def test_r2_hetero_budgets_pump_driven_matches():
    """Heterogeneous budgets, driven by pump() like a live front door
    (``max_wait_s=0``: every queued request is due, so admission does not
    depend on the clock): every request still gets its
    composition-invariant result, across budget-group splits, affinity
    shards and fusions."""
    def scenario(pkg):
        engine_a, router_a, qemb, _ = make_pool(pkg)
        engine_b, router_b, _, _ = make_pool(pkg)
        B = qemb.shape[0]
        rng = np.random.default_rng(11)
        levels = np.quantile(engine_a.costs, [0.4, 0.8]) * 2.5
        budgets = rng.choice(levels, size=B)
        rset = pkg.ReplicaSet(router_a, replicas=2, max_batch=8, max_wait_s=0.0)
        blocks = []
        for s in range(0, B, 24):
            blocks.append(rset.submit_many(
                np.arange(s, min(s + 24, B)), qemb[s:s + 24], budgets[s:s + 24]))
            rset.pump()
        rset.drain()
        assert all(b.done() for b in blocks)
        base = pkg.BatchScheduler(router_b, max_batch=B, max_wait_s=0.0)
        ref = base.submit_many(np.arange(B), qemb, budgets)
        base.drain()
        np.testing.assert_array_equal(
            np.concatenate([b.predictions for b in blocks]), ref.predictions)
        np.testing.assert_array_equal(np.concatenate([b.costs for b in blocks]), ref.costs)
        # pump() retires what is ready: how many groups ride in flight
        # depends on when the device finishes, so inflight_peak is left out
        st = {k: v for k, v in rset.stats.items() if k != "inflight_peak"}
        return {"blocks": blocks, "replica_stats": st}
    both(scenario)


def test_affinity_is_sticky_and_spill_caps_skew():
    """The same embedding always lands on the same replica; a block whose
    clusters all hash to one replica spills its tail to the least loaded."""
    def scenario(pkg):
        engine, router, qemb, _ = make_pool(pkg)
        budget = pool_budget(engine)
        rset = pkg.ReplicaSet(router, replicas=4, max_batch=16, max_wait_s=0.0)
        a1 = rset._assign(qemb, qemb.shape[0])
        np.testing.assert_array_equal(a1, rset._assign(qemb, qemb.shape[0]))
        one = np.repeat(qemb[:1], 64, axis=0)
        home = int(rset._assign(one[:1], 1)[0])
        before = rset.spills
        assign = rset._assign(one, 64)
        cap = int(np.ceil(rset.spill_factor * 64 / 4))
        counts = np.bincount(assign, minlength=4)
        assert counts[home] == cap                     # prefix stays home
        assert rset.spills - before == 64 - cap        # tail spilled elsewhere
        assert (counts > 0).sum() >= 2
        blk = rset.submit_many(np.arange(64) % qemb.shape[0], one, budget)
        rset.drain()
        assert blk.done() and (blk.predictions >= 0).all()
        return {"assign": a1, "spilled": assign, "blocks": [blk], "replica_stats": rset.stats}
    both(scenario)


def test_spill_multi_overflow_no_double_count_never_self_spill():
    """When several replicas overflow in one block, each sheds exactly its
    own tail once, every over-cap home ends at cap, and no spilled row
    lands back on its own home."""
    def scenario(pkg):
        engine, router, qemb, _ = make_pool(pkg)
        rset = pkg.ReplicaSet(router, replicas=4, max_batch=16, max_wait_s=0.0,
                              spill_factor=1.0)
        homes = {int(rset._assign(qemb[i:i + 1], 1)[0]): i for i in range(qemb.shape[0])}
        (h1, i1), (h2, i2) = list(homes.items())[:2]
        assert h1 != h2
        emb = np.concatenate([np.repeat(qemb[i1:i1 + 1], 32, axis=0),
                              np.repeat(qemb[i2:i2 + 1], 32, axis=0)])
        before = rset.spills
        assign = rset._assign(emb, 64)
        cap = int(np.ceil(rset.spill_factor * 64 / 4))
        counts = np.bincount(assign, minlength=4)
        assert counts[h1] == cap and counts[h2] == cap
        assert rset.spills - before == 64 - 2 * cap
        tails = np.concatenate([assign[:32][assign[:32] != h1],
                                assign[32:][assign[32:] != h2]])
        assert not np.isin(tails, [h1, h2]).any()
        assert counts.sum() == 64
        return {"assign": assign, "homes": (h1, h2), "spills": rset.spills}
    both(scenario)


def test_shard_merge_reproduces_single_log_estimator_state():
    """Labels stream through an R=3 replica plane (three local shard logs,
    merged at ONE central apply) vs the same labels through a single
    BatchScheduler log: the estimator ends bit-identical."""
    def scenario(pkg):
        engine_a, router_a, qemb, qlab = make_pool(pkg)
        engine_b, router_b, _, _ = make_pool(pkg)
        budget = pool_budget(engine_a)
        B = qemb.shape[0]
        rset = pkg.ReplicaSet(router_a, replicas=3, max_batch=16, max_wait_s=0.0,
                              feedback=True)
        blk = rset.submit_many(np.arange(B), qemb, budget)
        rset.drain()
        assert rset.record_outcomes(blk.request_ids, qlab) == B
        rep_r = rset.apply_feedback()
        base = pkg.BatchScheduler(router_b, max_batch=16, max_wait_s=0.0, feedback=True)
        ref = base.submit_many(np.arange(B), qemb, budget)
        base.drain()
        base.record_outcomes(ref.request_ids, qlab)
        rep_b = base.apply_feedback()
        assert rep_r.labels == rep_b.labels == B
        assert sorted(rep_r.clusters) == sorted(rep_b.clusters)
        assert sorted(rep_r.drifted) == sorted(rep_b.drifted)
        est_r = estimator_state(router_a.estimator)
        assert est_r == estimator_state(router_b.estimator)
        fr, fb = rset.stats, base.stats
        for k in ("feedback_labels", "feedback_applies", "feedback_drifts",
                  "feedback_unmatched"):
            assert fr[k] == fb[k], k
        return {"blocks": [blk], "replica_stats": fr, "estimator": est_r,
                "report": (rep_r.labels, sorted(rep_r.clusters), sorted(rep_r.drifted))}
    both(scenario)


def test_stray_labels_land_on_central_log():
    def scenario(pkg):
        engine, router, qemb, qlab = make_pool(pkg, B=32)
        rset = pkg.ReplicaSet(router, replicas=2, max_batch=16, max_wait_s=0.0,
                              feedback=True)
        blk = rset.submit_many(np.arange(32), qemb, pool_budget(engine))
        rset.drain()
        matched = rset.record_outcomes(np.concatenate([blk.request_ids, [10 ** 9]]),
                                       np.concatenate([qlab[:32], [0]]))
        assert matched == 32
        assert rset.stats["feedback_unmatched"] == 1
        return {"blocks": [blk], "replica_stats": rset.stats}
    both(scenario)


def test_replica_faults_complete_with_ledger_invariant():
    """Under an active FaultPolicy an R=3 fused stream completes, failure
    evidence reaches the degradation counters, and every tenant holds
    ``spent + reserved <= limit``; the port's faulted stream equals the
    reference's cell for cell."""
    def scenario(pkg):
        engine, router, qemb, qlab = make_pool(pkg)
        budget = pool_budget(engine)
        B = qemb.shape[0]
        ledger = pkg.CostLedger(num_arms=len(engine.arms))
        ledger.set_limit("acme", budget * B)
        policy = pkg.FaultPolicy(len(engine.arms), 4, seed=7)
        policy.set_arm(int(np.argmin(engine.costs)), timeout=0.4, error=0.3)
        engine.fault_policy = policy
        rset = pkg.ReplicaSet(router, replicas=3, max_batch=16, max_wait_s=0.0,
                              feedback=True, ledger=ledger)
        blk = rset.submit_many(np.arange(B), qemb, budget, tenant="acme")
        rset.drain()
        assert blk.done() and (blk.predictions >= 0).all()
        rset.record_outcomes(blk.request_ids, qlab)
        rset.apply_feedback()
        st = rset.stats
        assert st["degradation_failures"] > 0 and st["degradation_routes"] > 0
        ent = ledger.tenant("acme")
        assert ent["spent"] + ent["reserved"] <= ent["limit"] + 1e-9
        assert ent["reserved"] == 0.0
        assert np.isclose(ent["spent"], blk.costs.sum())
        return {"blocks": [blk], "replica_stats": st, "ledger": _ledger_state(ledger),
                "estimator": estimator_state(router.estimator)}
    both(scenario)


def test_replica_tenant_budget_rejections_match_baseline():
    """A tenant that runs out of budget mid-stream is rejected identically
    through the replica plane: prediction -1, cost 0, mode 'rejected',
    and the ledger never over-commits."""
    def scenario(pkg):
        engine_a, router_a, qemb, _ = make_pool(pkg)
        engine_b, router_b, _, _ = make_pool(pkg)
        budget = pool_budget(engine_a)
        B = qemb.shape[0]
        cap = budget * (B // 4)

        def run(replicated, router):
            ledger = pkg.CostLedger(num_arms=len(engine_a.arms))
            ledger.set_limit("acme", cap)
            if replicated:
                s = pkg.ReplicaSet(router, replicas=1, max_batch=16, max_wait_s=0.0,
                                   ledger=ledger)
            else:
                s = pkg.BatchScheduler(router, max_batch=16, max_wait_s=0.0, ledger=ledger)
            blk = s.submit_many(np.arange(B), qemb, budget, tenant="acme")
            s.drain()
            return blk, ledger

        blk_r, led_r = run(True, router_a)
        blk_b, led_b = run(False, router_b)
        assert_blocks_equal(blk_r, blk_b)
        rej = blk_r.modes == "rejected"
        assert rej.any()
        assert (blk_r.predictions[rej] == -1).all() and (blk_r.costs[rej] == 0).all()
        assert led_r.tenant("acme")["spent"] == led_b.tenant("acme")["spent"] <= cap
        return {"blocks": [blk_r], "ledger": _ledger_state(led_r)}
    both(scenario)
