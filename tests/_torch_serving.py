"""Shared set-up of the port's serving-front-door tests: the same scenario
built on the JAX package (``REF``) and on the port (``PORT``) from the same
numpy seeds, so each test runs it on both and compares.

Both namespaces hold the classes a scenario needs under one set of names.
The reference's router is built with ``donate_buffers=False``; the port's
on the CPU. Oracle arms and tabular arms draw from numpy, identically on
both sides.
"""
import dataclasses
import functools
import types

import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):      # removed in jax 0.9
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np
import pytest
import torch

import repro.core.clustering as j_clustering
import repro.core.estimation as j_estimation
import repro.data as j_data
import repro.distributed.fault as j_fault
import repro.serving as j_serving
import repro_torch.core.clustering as t_clustering
import repro_torch.core.estimation as t_estimation
import repro_torch.data.synth as t_data
import repro_torch.distributed.fault as t_fault
import repro_torch.serving as t_serving


@pytest.fixture(autouse=True)
def one_torch_thread():
    """Run torch on one CPU thread for the test (imported into a test module,
    it applies to every test there). These scenarios run many small torch
    ops, and the idle threads of torch's pool spin between them: with
    several test workers on one machine the spinning starves every worker.
    The results do not depend on the thread count."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _namespace(name, data, clustering, estimation, fault, serving, **router_kw):
    ns = types.SimpleNamespace(
        name=name, OracleWorkload=data.OracleWorkload, kmeans=clustering.kmeans,
        SuccessProbEstimator=estimation.SuccessProbEstimator,
        wilson_interval=estimation.wilson_interval, fault=fault,
        ThriftRouter=functools.partial(serving.ThriftRouter, **router_kw),
    )
    for attr in ("PoolEngine", "OracleArm", "BatchScheduler", "FeedbackLog", "FeedbackShard",
                 "DegradationTracker", "merge_counts", "Request", "CostLedger", "PlanService",
                 "FaultPolicy", "ArmFaultSpec"):
        setattr(ns, attr, getattr(serving, attr))
    return ns


REF = _namespace("ref", j_data, j_clustering, j_estimation, j_fault, j_serving,
                 donate_buffers=False)
PORT = _namespace("port", t_data, t_clustering, t_estimation, t_fault, t_serving, device="cpu")
PACKAGES = (REF, PORT)


@dataclasses.dataclass
class TabularArm:
    """Deterministic arm: response to query j is the precomputed resp[j]."""

    name: str
    cost: float
    resp: np.ndarray
    metered: bool = False

    def classify_batch(self, queries) -> np.ndarray:
        return self.resp[np.asarray(queries, np.int64)]

    def latency_s(self, batch: int) -> float:
        return 1e-6 * self.cost * batch


def tabular_pool(pkg, K=4, L=8, clusters=5, B=96, seed=3, metered=False, **router_kw):
    """Deterministic pool (bit-identical equivalence testing): ``(est,
    engine, router, qemb, qlab)``."""
    wl = pkg.OracleWorkload(num_classes=K, num_clusters=clusters, num_arms=L, seed=seed)
    T, emb, _ = wl.response_table(60 * clusters, seed=seed + 1)
    assign, _ = pkg.kmeans(emb, clusters, seed=0)
    est = pkg.SuccessProbEstimator(T, emb, assign)
    rng = np.random.default_rng(seed + 2)
    qcid, qemb, qlab = wl.sample_queries(B, rng)
    R = np.stack([wl.invoke_batch(a, qcid, qlab, np.random.default_rng(seed + 100 + a))
                  for a in range(L)])
    engine = pkg.PoolEngine([TabularArm(f"t{a}", float(wl.costs[a]), R[a], metered=metered)
                             for a in range(L)])
    router = pkg.ThriftRouter(engine, est, num_classes=K, **router_kw)
    return est, engine, router, qemb, qlab


def oracle_pool(pkg, K=4, C=4, L=12, hist=120, seed=3, arm_seed=11, est_seed=4, **router_kw):
    """Oracle pool over *true* cluster ids (truth mutable through
    ``OracleWorkload.drift_arms``): ``(wl, est, engine, router)``."""
    wl = pkg.OracleWorkload(num_classes=K, num_clusters=C, num_arms=L, seed=seed)
    T, emb, cid_h = wl.response_table(hist * C, seed=est_seed)
    est = pkg.SuccessProbEstimator(T, emb, cid_h)
    engine = pkg.PoolEngine([pkg.OracleArm(f"a{i}", wl, i, seed=arm_seed) for i in range(L)])
    router = pkg.ThriftRouter(engine, est, num_classes=K, **router_kw)
    return wl, est, engine, router


ROUTE_FIELDS = ("predictions", "costs", "planned_costs", "clusters", "schedule", "responses",
                "invoked", "arm_query_counts", "stop_waves")
FAULT_FIELDS = ("fault_schedule", "fault_codes", "arm_fault_counts")
BLOCK_FIELDS = ("predictions", "costs", "planned_costs", "clusters", "budgets", "stop_waves",
                "modes", "request_ids")


def assert_routes_equal(got, want, tag=""):
    """Bitwise: every route field, the wave count and the fault evidence."""
    for f in ROUTE_FIELDS + FAULT_FIELDS:
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None) == (b is None), f"{tag}:{f}"
        if a is not None:
            np.testing.assert_array_equal(a, b, err_msg=f"{tag}:{f}")
    assert got.waves == want.waves, tag


def assert_blocks_equal(got, want, tag=""):
    """Bitwise: every time-free column of two BlockFutures."""
    for f in BLOCK_FIELDS:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), err_msg=f"{tag}:{f}")


def plan_state(plan):
    """A GroupPlan's arrays and scalars, for equality."""
    return (plan.order.tolist(), plan.weights.tobytes(), plan.residual.tobytes(),
            float(plan.planned), float(plan.empty))


def both(scenario, *args, **kwargs):
    """Run ``scenario(pkg, ...)`` on both packages; assert the port's
    returned observables equal the reference's (dicts of stats compared on
    the port's keys); return the port's."""
    want = scenario(REF, *args, **kwargs)
    got = scenario(PORT, *args, **kwargs)
    assert_same(got, want)
    return got


def assert_same(got, want, tag="out"):
    if isinstance(got, dict) and tag.startswith("stats"):
        assert got == {k: want[k] for k in got}, tag
    elif isinstance(got, dict):
        assert got.keys() == want.keys(), tag
        for k in got:
            assert_same(got[k], want[k], f"{k}" if isinstance(k, str) else f"{tag}[{k}]")
    elif isinstance(got, (list, tuple)) and got and hasattr(got[0], "predictions"):
        assert len(got) == len(want), tag
        for a, b in zip(got, want):
            assert_same(a, b, tag)
    elif hasattr(got, "request_ids"):
        assert_blocks_equal(got, want, tag)
    elif hasattr(got, "arm_query_counts"):
        assert_routes_equal(got, want, tag)
    elif isinstance(got, np.ndarray):
        assert got.dtype == np.asarray(want).dtype, tag
        np.testing.assert_array_equal(got, want, err_msg=tag)
    else:
        assert got == want, tag


def estimator_state(est):
    """Every per-cluster array and version of an estimator, for equality."""
    out = {"version": est.version, "plan_version": est.plan_version}
    for cid, st in sorted(est.clusters.items()):
        out[cid] = (st.p_hat.tobytes(), st.arm_counts.tobytes(), st.lo.tobytes(),
                    st.hi.tobytes(), st.count, st.version, st.plan_p_hat.tobytes(),
                    st.plan_arm_counts.tobytes())
    return out
