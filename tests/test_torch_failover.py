"""The port's fault plane against the JAX package's: ``tests/test_failover.py``'s
scenarios (all but the jit-recompile guard and the replica set, which have
no counterpart yet) run on both packages from the same seeds.

Each case asserts the reference's own contract on the port — the device
wave plane and the compacting host plane agree under every fault schedule,
a zero-rate policy changes nothing, a total outage degrades gracefully,
failure evidence drift-replans only the observing clusters and probes
readmit a recovered arm — and that the port's routes, fault evidence,
scheduler results and estimator states equal the reference's bitwise (f64
planes).
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
    REF,
    assert_blocks_equal,
    assert_routes_equal,
    estimator_state,
    one_torch_thread,  # noqa: F401  (autouse: torch on one CPU thread)
    oracle_pool,
    tabular_pool,
)
from repro_torch import convert


def _budget(engine):
    return float(np.quantile(engine.costs, 0.8) * 3)


def _early_arm(router, qemb, budget):
    """The arm most batches invoke at wave 0."""
    res = router.route_batch(np.arange(qemb.shape[0]), qemb, budget)
    first = res.schedule[:, 0]
    return int(np.bincount(first[first >= 0]).argmax())


def _assert_planes_equal(tag, rj, rr):
    """The reference's jit-vs-reference pin: costs summed in two orders
    agree to 1e-15, everything else bitwise."""
    for f in ("predictions", "schedule", "responses", "invoked", "arm_query_counts",
              "stop_waves", "clusters"):
        np.testing.assert_array_equal(getattr(rj, f), getattr(rr, f), err_msg=f"{tag}:{f}")
    np.testing.assert_allclose(rj.costs, rr.costs, rtol=1e-15, atol=0, err_msg=f"{tag}:costs")
    assert rj.waves == rr.waves, (tag, rj.waves, rr.waves)
    if rj.fault_codes is not None or rr.fault_codes is not None:
        for f in ("fault_schedule", "fault_codes", "arm_fault_counts"):
            np.testing.assert_array_equal(getattr(rj, f), getattr(rr, f), err_msg=f"{tag}:{f}")


FAULT_MATRIX = [
    ("timeout", {0: dict(timeout=0.5)}),
    ("error", {0: dict(error=0.7), 1: dict(error=0.3)}),
    ("degrade", {0: dict(degrade=0.6)}),
    ("mixed", {0: dict(timeout=0.3, degrade=0.2), 1: dict(error=0.4),
               2: dict(timeout=0.2, error=0.2)}),
]


@pytest.mark.parametrize("failover", [True, False], ids=["failover", "frozen"])
@pytest.mark.parametrize("kind,rates", FAULT_MATRIX)
def test_jit_matches_reference_under_faults(kind, rates, failover):
    routes = {}
    for pkg in PACKAGES:
        est, engine, router, qemb, qlab = tabular_pool(pkg, failover=failover)
        budget = _budget(engine)
        order = np.argsort(-np.bincount(
            router.route_batch(np.arange(96), qemb, budget).schedule[:, 0].clip(0),
            minlength=len(engine.arms)))
        policy = pkg.FaultPolicy(len(engine.arms), 4, seed=7)
        for pos, kw in rates.items():
            policy.set_arm(int(order[pos]), **kw)
        engine.fault_policy = policy
        rj = router.route_batch(np.arange(96), qemb, budget)
        rr = router.route_batch_reference(np.arange(96), qemb, budget)
        _assert_planes_equal(f"{pkg.name}:{kind}/{failover}", rj, rr)
        assert rj.fault_codes is not None
        if kind != "degrade":
            assert rj.arm_fault_counts.sum() > 0
            hit = np.flatnonzero(rj.arm_fault_counts)
            assert set(hit.tolist()) <= {int(order[p]) for p in rates}
        if failover:
            assert (rj.responses[rj.invoked] >= 0).all()
        routes[pkg.name] = (rj, rr)
    for plane in (0, 1):
        assert_routes_equal(routes["port"][plane], routes["ref"][plane], f"{kind}/{plane}")


def test_heterogeneous_budgets_under_faults():
    routes = {}
    for pkg in PACKAGES:
        est, engine, router, qemb, qlab = tabular_pool(pkg)
        rng = np.random.default_rng(11)
        budgets = rng.choice(np.quantile(engine.costs, [0.4, 0.8]) * 2.5, size=96)
        hot = _early_arm(router, qemb, float(budgets.max()))
        policy = pkg.FaultPolicy(len(engine.arms), 4, seed=13)
        policy.set_arm(hot, timeout=0.4, degrade=0.1)
        engine.fault_policy = policy
        rj = router.route_batch(np.arange(96), qemb, budgets)
        rr = router.route_batch_reference(np.arange(96), qemb, budgets)
        _assert_planes_equal(f"{pkg.name}:hetero", rj, rr)
        routes[pkg.name] = (rj, rr)
    for plane in (0, 1):
        assert_routes_equal(routes["port"][plane], routes["ref"][plane], f"hetero/{plane}")


@pytest.mark.parametrize("mode", ["jit", "reference"])
def test_fault_row_offset_shifts_the_draws_like_reference(mode):
    """A group dispatched at ``fault_row_offset`` draws the faults of those
    rows of a fused batch: the port's route equals the reference's, and
    equals the fused route's rows."""
    routes = {}
    for pkg in PACKAGES:
        est, engine, router, qemb, qlab = tabular_pool(pkg)
        budget = _budget(engine)
        policy = pkg.FaultPolicy(len(engine.arms), 4, seed=21)
        policy.set_arms(range(len(engine.arms)), timeout=0.2, error=0.1, degrade=0.1)
        engine.fault_policy = policy
        part = router.begin_route(np.arange(40, 96), qemb[40:], budget, mode=mode,
                                  fault_row_offset=40).result()
        fused = router.begin_route(np.arange(96), qemb, budget, mode=mode).result()
        for f in ("fault_codes", "predictions", "schedule", "responses"):
            np.testing.assert_array_equal(getattr(part, f), getattr(fused, f)[40:], err_msg=f)
        assert part.fault_codes.any()
        routes[pkg.name] = (part, fused)
    for got, want in zip(routes["port"], routes["ref"]):
        assert_routes_equal(got, want, mode)


def test_zero_fault_bit_identical_to_policy_free():
    """An attached all-zero policy changes nothing on either plane of the
    port, and leaves no fault evidence."""
    est_a, engine_a, router_a, qemb, _ = tabular_pool(PORT)
    est_b, engine_b, router_b, _, _ = tabular_pool(PORT)
    engine_b.fault_policy = PORT.FaultPolicy(len(engine_b.arms), 4, seed=7)
    budget = _budget(engine_a)
    base_j = router_a.route_batch(np.arange(96), qemb, budget)
    base_r = router_a.route_batch_reference(np.arange(96), qemb, budget)
    z_j = router_b.route_batch(np.arange(96), qemb, budget)
    z_r = router_b.route_batch_reference(np.arange(96), qemb, budget)
    for base, z in ((base_j, z_j), (base_r, z_r)):
        assert_routes_equal(z, base)
        assert z.fault_codes is None and z.arm_fault_counts is None
    assert engine_b.fault_grid(base_j.schedule.T) == (None, None)


@pytest.mark.parametrize("failover", [True, False], ids=["failover", "frozen"])
def test_fully_failed_plan_degrades_gracefully(failover):
    out = {}
    for pkg in PACKAGES:
        est, engine, router, qemb, qlab = tabular_pool(pkg, failover=failover)
        policy = pkg.FaultPolicy(len(engine.arms), 4, seed=7)
        policy.set_arms(range(len(engine.arms)), error=1.0)
        engine.fault_policy = policy
        budget = _budget(engine)
        rj = router.route_batch(np.arange(96), qemb, budget)
        rr = router.route_batch_reference(np.arange(96), qemb, budget)
        _assert_planes_equal(f"{pkg.name}:all-dead", rj, rr)
        assert (rj.costs == 0).all() and not rj.invoked.any()
        assert (rj.predictions >= 0).all() and (rj.predictions < 4).all()
        assert rj.arm_fault_counts.sum() > 0 and rj.waves == 0
        sched = pkg.BatchScheduler(router, max_batch=32, feedback=True)
        blk = sched.submit_many(np.arange(96), qemb, budget)
        sched.drain()
        assert blk.done() and (blk.costs == 0).all()
        assert sched.stats["degradation_failures"] > 0
        out[pkg.name] = (rj, blk, sched.stats["degradation_failures"])
    assert_routes_equal(out["port"][0], out["ref"][0])
    assert_blocks_equal(out["port"][1], out["ref"][1])
    assert out["port"][2] == out["ref"][2]


def test_failures_drift_replan_only_observing_clusters_then_readmit():
    """A persistently erroring arm is replanned away from failure evidence
    alone, for exactly the observing clusters; probes readmit it after
    recovery. Both packages take the same steps to the same estimator."""
    seen = {}
    for pkg in PACKAGES:
        wl, est, engine, router = oracle_pool(pkg)
        budget = float(np.quantile(engine.costs, 0.5)) * 2
        sched = pkg.BatchScheduler(router, max_batch=256, max_wait_s=0.0, feedback=True)
        rng = np.random.default_rng(5)
        cid, qemb, lab = wl.sample_queries(256, rng)
        res0 = router.route_batch(np.column_stack([cid, lab]), qemb, budget)
        first = res0.schedule[:, 0]
        hot = int(np.bincount(first[first >= 0]).argmax())
        observers = sorted(set(res0.clusters[first == hot].tolist()))
        others = [c for c in est.clusters if c not in observers]
        plans_before = {c: router.plans.plan(int(c), budget).order.copy() for c in est.clusters}
        p_before = {c: float(est.clusters[c].p_hat[hot]) for c in est.clusters}

        policy = pkg.FaultPolicy(len(engine.arms), 4, seed=9)
        policy.set_arm(hot, error=0.95)
        engine.fault_policy = policy
        blocks = []
        for _ in range(3):
            cid, qemb, lab = wl.sample_queries(256, rng)
            blocks.append(sched.submit_many(np.column_stack([cid, lab]), qemb, budget))
            sched.drain()
            policy.advance()
        sched.apply_feedback()
        st = dict(sched.stats)
        assert st["degradation_failures"] > 0 and st["feedback_drifts"] >= 1
        drifted = [int(c) for c in est.clusters if est.clusters[c].version > 0]
        assert drifted and set(drifted) <= set(int(c) for c in observers)
        assert all(est.clusters[c].version == 0 for c in others)
        for c in drifted:
            assert router.plans.plan(c, budget).order[0] != hot
            assert est.clusters[c].p_hat[hot] < p_before[c] - 0.2
        for c in others:
            np.testing.assert_array_equal(router.plans.plan(int(c), budget).order,
                                          plans_before[c])
        after_faults = estimator_state(est)

        engine.fault_policy = None
        sched.feedback.probe_rate = 1.0
        p_collapsed = {c: est.clusters[c].p_hat[hot] for c in drifted}
        for _ in range(6):
            cid, qemb, lab = wl.sample_queries(256, rng)
            blk = sched.submit_many(np.column_stack([cid, lab]), qemb, budget)
            sched.drain()
            sched.record_outcomes(blk.request_ids, lab)
            blocks.append(blk)
        sched.apply_feedback()
        assert any(est.clusters[c].p_hat[hot] > p_collapsed[c] + 0.05 for c in drifted)
        seen[pkg.name] = (st, after_faults, estimator_state(est), blocks, dict(sched.stats))
    got, want = seen["port"], seen["ref"]
    assert got[0] == {k: want[0][k] for k in got[0]}
    assert got[1] == want[1] and got[2] == want[2]
    for b_got, b_want in zip(got[3], want[3]):
        assert_blocks_equal(b_got, b_want)
    assert got[4] == {k: want[4][k] for k in got[4]}


def test_engine_fault_grid_matches_reference():
    """``PoolEngine.fault_grid`` with an attached policy: the reference's
    codes and failed mask, at a row offset too; (None, None) once the
    policy is cleared."""
    grids = {}
    for pkg in PACKAGES:
        est, engine, router, qemb, _ = tabular_pool(pkg)
        sched_T = router.route_batch(np.arange(96), qemb, _budget(engine)).schedule.T
        engine.fault_policy = pkg.FaultPolicy(len(engine.arms), 4, seed=5).set_arms(
            [0, 3, 6], timeout=0.3, error=0.2, degrade=0.1)
        grids[pkg.name] = [engine.fault_grid(sched_T), engine.fault_grid(sched_T, row_offset=9)]
        engine.fault_policy.clear()
        assert engine.fault_grid(sched_T) == (None, None)
    for (codes, failed), (want_codes, want_failed) in zip(grids["port"], grids["ref"]):
        assert codes.dtype == want_codes.dtype and codes.any()
        np.testing.assert_array_equal(codes, want_codes)
        np.testing.assert_array_equal(failed, want_failed)


def test_failover_gather_invariants():
    rng = np.random.default_rng(0)
    depth = rng.integers(1, 7, size=9)
    sched_T = np.where(np.arange(6)[:, None] < depth[None, :],
                       rng.integers(0, 5, (6, 9)), -1).astype(np.int64)
    failed = (rng.random((6, 9)) < 0.3) & (sched_T >= 0)
    src, valid, rank, navail = PORT.fault.failover_gather(sched_T, failed)
    for got, want in zip((src, valid, rank, navail), REF.fault.failover_gather(sched_T, failed)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    eff = np.where(valid, sched_T[src, np.arange(9)[None, :]], -1)
    for b in range(9):
        col = sched_T[:, b]
        want = col[(col >= 0) & ~failed[:, b]]
        np.testing.assert_array_equal(eff[:, b][eff[:, b] >= 0], want)
        assert navail[b] == want.size
    src0, valid0, _, _ = PORT.fault.failover_gather(sched_T, np.zeros_like(failed))
    np.testing.assert_array_equal(np.where(valid0, sched_T[src0, np.arange(9)[None, :]], -1),
                                  sched_T)
    stop = rng.integers(0, 7, size=9)
    codes = PORT.FaultPolicy(5, 3, seed=2).set_arms(range(5), timeout=0.2, error=0.2,
                                                   degrade=0.2).grid_codes(sched_T)
    for args in ((codes, sched_T, stop), (codes, sched_T, stop, rank, navail)):
        np.testing.assert_array_equal(PORT.fault.observed_faults(*args),
                                      REF.fault.observed_faults(*args))


def test_fault_policy_determinism_and_spec():
    """Same (seed, epoch, cell) -> same draw, on both packages bitwise;
    advance() moves the epoch; a policy crosses packages through
    ``convert``."""
    policies = {}
    for pkg in PACKAGES:
        p1, p2 = pkg.FaultPolicy(4, 3, seed=5), pkg.FaultPolicy(4, 3, seed=5)
        for p in (p1, p2):
            p.set_arm(2, timeout=0.3, degrade=0.2)
        sched_T = np.full((4, 16), 2, np.int64)
        np.testing.assert_array_equal(p1.grid_codes(sched_T), p2.grid_codes(sched_T))
        np.testing.assert_array_equal(p1.corrupt_grid(sched_T), p2.corrupt_grid(sched_T))
        before = p1.grid_codes(sched_T)
        p1.advance()
        assert not np.array_equal(p1.grid_codes(sched_T), before)
        assert p1.spec(2) == pkg.ArmFaultSpec(timeout=0.3, degrade=0.2)
        with pytest.raises(ValueError):
            pkg.ArmFaultSpec(timeout=0.9, error=0.2)
        policies[pkg.name] = p1
    rng = np.random.default_rng(4)
    sched_T = np.where(rng.random((7, 50)) < 0.8, rng.integers(0, 4, (7, 50)), -1)
    rows, arms = np.arange(50), rng.integers(0, 4, 50)
    port = convert.fault_policy_from_state(convert.fault_policy_state(policies["ref"]))
    for p in (policies["port"], port):
        for method, args in (("grid_codes", (sched_T, 3)), ("corrupt_grid", (sched_T, 3)),
                             ("row_codes", (arms, rows)), ("corrupt_rows", (arms, rows))):
            got, want = getattr(p, method)(*args), getattr(policies["ref"], method)(*args)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want, err_msg=method)
