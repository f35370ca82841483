"""The port's router against the JAX package's, on state carried across by
``repro_torch.convert``.

The workload, oracle pool and calibration history are built once by the JAX
package; ``convert`` turns their numpy state into the port's objects. Both
routers then serve the same batches in the same order (oracle arms draw from
numpy generators, identical on both sides):

* f64 planes — ``route_batch``, ``route_batch_reference`` and
  ``route_batch_sequential`` give bitwise equal predictions, costs, planned
  costs, stop waves, schedules, responses and beliefs, for uniform budgets
  (batched planner) and mixed budgets (serial planner);
* kernel planes (``use_kernel=True`` on both sides) — equal predictions and
  stop waves, beliefs within 1e-6, except rows whose f64 Prop. 4 margin lies
  within 1e-6 of STOP_MARGIN (the documented f32 stop-boundary caveat); the
  test counts those rows.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):      # removed in jax 0.9
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np
import pytest

from repro.core.clustering import kmeans
from repro.core.estimation import SuccessProbEstimator
from repro.core.selection import STOP_MARGIN
from repro.data import OracleWorkload
from repro.serving import OracleArm, PoolEngine, ThriftRouter
from repro_torch import convert

K, L, CLUSTERS, B = 4, 6, 3, 40
EPS, DELTA = 0.5, 0.2
FIELDS = ("predictions", "costs", "planned_costs", "clusters", "schedule",
          "responses", "invoked", "arm_query_counts", "stop_waves")


@pytest.fixture(scope="module")
def state():
    """JAX-built state, as the numpy dicts ``convert`` takes."""
    wl = OracleWorkload(num_classes=K, num_clusters=CLUSTERS, num_arms=L, seed=3)
    table, emb, _ = wl.response_table(300, seed=4)
    assign, _ = kmeans(emb, CLUSTERS, seed=0)
    engine = PoolEngine([OracleArm(f"a{i}", wl, i, seed=5) for i in range(L)])
    rng = np.random.default_rng(1)
    batches = []
    for i in range(2):
        cid, qemb, lab = wl.sample_queries(B, rng)
        budget = (float(np.quantile(wl.costs, 0.6)) * 2 if i == 0
                  else rng.choice(np.quantile(wl.costs, [0.3, 0.8]) * 2.5, size=B))
        batches.append((np.stack([cid, lab], 1), qemb, budget))
    return {
        "wl": wl, "history": {"table": table, "emb": emb, "assign": assign},
        "workload": convert.workload_state(wl), "arms": convert.arms_state(engine),
        "batches": batches,
    }


def _routers(state, use_kernel):
    """A fresh (reference, port) router pair over identical state."""
    h = state["history"]
    ref = ThriftRouter(
        PoolEngine([OracleArm(a["name"], state["wl"], a["arm_index"], seed=a["seed"])
                    for a in state["arms"]]),
        SuccessProbEstimator(h["table"], h["emb"], h["assign"]), K,
        eps=EPS, delta=DELTA, use_kernel=use_kernel, donate_buffers=False,
    )
    port = convert.router_from_state(state["workload"], h, state["arms"], K,
                                     eps=EPS, delta=DELTA, use_kernel=use_kernel, device="cpu")
    return ref, port


def _ref_beliefs(pending, res, use_kernel):
    """The reference route's final (B, K) beliefs, read from its handle."""
    if pending.kind == "jit":
        return np.asarray(pending._dev[2], np.float64)[: res.predictions.size]
    if use_kernel:
        return pending.router._kernel_beliefs(res.responses, pending.weights, pending.empty)
    return np.where(pending.voted, pending.vote, pending.empty[:, None])


def _route(router, method, q, e, budget):
    if method == "route_batch_sequential":
        return router.route_batch_sequential(q, e, budget), None
    mode = "jit" if method == "route_batch" else "reference"
    pending = router.begin_route(q, e, budget, mode=mode)
    return pending.result(), pending


def test_convert_round_trip(state):
    wl = convert.workload_from_state(state["workload"])
    for name in ("centers", "p_true", "costs"):
        np.testing.assert_array_equal(getattr(wl, name), getattr(state["wl"], name))
    again = convert.workload_state(wl)
    assert again.keys() == state["workload"].keys()
    engine = convert.engine_from_state(wl, state["arms"])
    np.testing.assert_array_equal(engine.costs, state["wl"].costs)
    assert engine.pooled


@pytest.mark.parametrize("method", ["route_batch", "route_batch_reference", "route_batch_sequential"])
def test_f64_planes_bitwise(state, method):
    ref, port = _routers(state, use_kernel=False)
    for q, e, budget in state["batches"]:
        want, pending = _route(ref, method, q, e, budget)
        got, _ = _route(port, method, q, e, budget)
        for field in FIELDS:
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
        assert got.waves == want.waves and got.arms_used == want.arms_used
        if pending is not None:
            np.testing.assert_array_equal(got.beliefs, _ref_beliefs(pending, want, False))
    # both routers planned the same pairs to the same plans
    assert ref.selector._cache.keys() == port.selector._cache.keys()
    for key, sel in ref.selector._cache.items():
        other = port.selector._cache[key]
        assert np.array_equal(sel.chosen, other.chosen) and sel.xi_est == other.xi_est


def _boundary_rows(pending, res):
    """Rows whose f64 Prop. 4 margin ``h1 - h2 - residual`` lies within 1e-6
    of STOP_MARGIN at some wave up to their stop, recomputed in numpy f64
    from the route's own plan tables."""
    T, Bn = pending.sched_T.shape
    Kc = pending.router.num_classes
    vote = np.zeros((Bn, Kc))
    voted = np.zeros((Bn, Kc), bool)
    near = np.zeros(Bn, bool)
    resp_T = res.responses.T
    rows = np.arange(Bn)
    for t in range(T):
        bel = np.where(voted, vote, pending.empty[:, None])
        part = np.sort(bel, axis=1)
        margin = part[:, -1] - part[:, -2] - pending.res_T[t]
        live = (pending.sched_T[t] >= 0) & (t <= res.stop_waves)
        near |= live & (np.abs(margin - STOP_MARGIN) <= 1e-6)
        ok = resp_T[t] >= 0
        vote[rows[ok], resp_T[t][ok]] += pending.w_T[t][ok]
        voted[rows[ok], resp_T[t][ok]] = True
    return near


@pytest.mark.parametrize("method", ["route_batch", "route_batch_reference"])
def test_kernel_planes(state, method):
    ref, port = _routers(state, use_kernel=True)
    exempt = 0
    for q, e, budget in state["batches"]:
        want, pending = _route(ref, method, q, e, budget)
        got, port_pending = _route(port, method, q, e, budget)
        near = _boundary_rows(port_pending, got)
        differ = ((got.predictions != want.predictions)
                  | (got.stop_waves != want.stop_waves))
        assert not (differ & ~near).any(), np.flatnonzero(differ & ~near)
        exempt += int(near.sum())
        same = ~near
        np.testing.assert_allclose(got.beliefs[same], _ref_beliefs(pending, want, True)[same],
                                   rtol=0, atol=1e-6)
        np.testing.assert_array_equal(got.costs[same], want.costs[same])
    assert exempt == 0          # no row of these batches sits on the boundary
    for key, sel in ref.selector._cache.items():
        other = port.selector._cache[key]
        assert np.array_equal(sel.chosen, other.chosen)
        assert abs(sel.xi_est - other.xi_est) <= 2e-6


def test_route_result_shapes_and_budget(state):
    _, port = _routers(state, use_kernel=False)
    q, e, budget = state["batches"][1]
    res = port.route_batch(q, e, budget)
    assert res.beliefs.shape == (B, K) and np.isfinite(res.beliefs).all()
    assert (res.costs <= np.asarray(budget) + 1e-15).all()
    assert (res.costs <= res.planned_costs + 1e-15).all()
    empty = port.route_batch(q[:0], e[:0], 1.0)
    assert empty.predictions.size == 0


@pytest.mark.parametrize("metered", [(), (1,)])
def test_auto_mode_picks_the_reference_kind(state, metered):
    """``begin_route(mode="auto")`` chooses the data plane from the metered
    arms' speculation cost exactly as the reference does."""
    arms = [dict(a, metered=a["arm_index"] in metered) for a in state["arms"]]
    h = state["history"]
    ref = ThriftRouter(
        PoolEngine([OracleArm(a["name"], state["wl"], a["arm_index"], seed=a["seed"],
                              metered=a["metered"]) for a in arms]),
        SuccessProbEstimator(h["table"], h["emb"], h["assign"]), K,
        eps=EPS, delta=DELTA, donate_buffers=False,
    )
    port = convert.router_from_state(state["workload"], h, arms, K, eps=EPS, delta=DELTA,
                                     device="cpu")
    q, e, budget = state["batches"][0]
    want, got = ref.begin_route(q, e, budget), port.begin_route(q, e, budget)
    assert got.kind == want.kind == ("reference" if metered else "jit")
    assert got.spec_cost == want.spec_cost
    np.testing.assert_array_equal(got.result().predictions, want.result().predictions)


def test_reference_plane_steps_like_reference(state):
    """Wave by wave, the compacting plane retires the same rows with the
    same predictions."""
    ref, port = _routers(state, use_kernel=False)
    q, e, budget = state["batches"][1]
    want = ref.begin_route(q, e, budget, mode="reference")
    got = port.begin_route(q, e, budget, mode="reference")
    assert got.ready()
    while not want.exhausted:
        (wr, wp), (gr, gp) = want.step(), got.step()
        np.testing.assert_array_equal(gr, wr)
        np.testing.assert_array_equal(gp, wp)
    assert got.exhausted
    np.testing.assert_array_equal(got.result().costs, want.result().costs)


def test_estimate_update_replans_like_reference(state):
    """An estimator update invalidates the updated cluster's plans on both
    sides; the next routes are again bitwise equal, with equal cache
    accounting."""
    ref, port = _routers(state, use_kernel=False)
    outcomes = (np.random.default_rng(8).random((30, L)) < 0.9).astype(np.float64)
    for q, e, budget in state["batches"]:
        ref.route_batch(q, e, budget)
        port.route_batch(q, e, budget)
    for router in (ref, port):
        router.estimator.update(int(router.estimator.cluster_order[0]), outcomes)
    for q, e, budget in state["batches"]:
        want, got = ref.route_batch(q, e, budget), port.route_batch(q, e, budget)
        for field in FIELDS:
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
    want_stats, got_stats = ref.plans.stats(), port.plans.stats()
    assert got_stats == {k: want_stats[k] for k in got_stats}
    assert got_stats["plan_invalidations"] == 1 and got_stats["plan_stale_dropped"] > 0
