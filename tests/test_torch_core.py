"""The port's host-side core against the JAX package: the workload generator,
K-means, DBSCAN and its eps heuristic, the success-probability estimator,
the closed-form and exact correctness functions, GreedyLLM on gamma, the
adaptive invocation loop, and the public names of the two grouped xi cores.

All but the xi cores are numpy in both packages; every comparison is
bitwise. The one statistical check holds the port's CRN estimator to the
exact enumeration of xi.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):      # removed in jax 0.9
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np
import pytest
import torch

from repro.core import clustering as jclu
from repro.core import correctness as jcor
from repro.core import estimation as jest
from repro.core import mc as jmc
from repro.core import selection as jsel
from repro.data import OracleWorkload as JaxOracleWorkload
from repro_torch.core import clustering as tclu
from repro_torch.core import correctness as tcor
from repro_torch import core as tcore
from repro_torch.core import estimation as tsp
from repro_torch.core import prng
from repro_torch.core import selection as tsel
from repro_torch.core.mc import GroupedXiEstimator
from repro_torch.data.synth import OracleWorkload


@pytest.mark.parametrize("seed,K,C,L", [(0, 4, 3, 6), (5, 77, 6, 12)])
def test_workload_draws_bitwise(seed, K, C, L):
    ref = JaxOracleWorkload(num_classes=K, num_clusters=C, num_arms=L, seed=seed)
    port = OracleWorkload(num_classes=K, num_clusters=C, num_arms=L, seed=seed)
    for name in ("centers", "p_true", "costs"):
        np.testing.assert_array_equal(getattr(port, name), getattr(ref, name))
    for a, b in zip(port.response_table(120, seed=2), ref.response_table(120, seed=2)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(port.sample_queries(50, np.random.default_rng(3)),
                    ref.sample_queries(50, np.random.default_rng(3))):
        np.testing.assert_array_equal(a, b)
    arms = np.arange(50) % L
    cl, lab = np.arange(50) % C, np.arange(50) % K
    np.testing.assert_array_equal(
        port.invoke_assigned(arms, cl, lab, np.random.default_rng(4)),
        ref.invoke_assigned(arms, cl, lab, np.random.default_rng(4)),
    )


@pytest.mark.parametrize("boost", [False, True])
def test_kmeans_and_estimator_bitwise(boost):
    wl = JaxOracleWorkload(num_classes=4, num_clusters=4, num_arms=5, seed=1)
    table, emb, _ = wl.response_table(240, seed=7)
    assign, cent = tclu.kmeans(emb, 4, seed=0)
    want_assign, want_cent = jclu.kmeans(emb, 4, seed=0)
    np.testing.assert_array_equal(assign, want_assign)
    np.testing.assert_array_equal(cent, want_cent)
    ref = jest.SuccessProbEstimator(table, emb, assign, boost=boost)
    port = tsp.SuccessProbEstimator(table, emb, assign, boost=boost)
    assert ref.clusters.keys() == port.clusters.keys()
    for cid, st in ref.clusters.items():
        mine = port.clusters[cid]
        for name in ("centroid", "p_hat", "lo", "hi", "arm_counts"):
            np.testing.assert_array_equal(getattr(mine, name), getattr(st, name), err_msg=name)
        assert mine.count == st.count
    np.testing.assert_array_equal(port.cluster_order, ref.cluster_order)
    np.testing.assert_array_equal(port.lookup_batch(emb[:50]), ref.lookup_batch(emb[:50]))
    qc, want = port.query_class(emb[0], 4, alpha=0.2), ref.query_class(emb[0], 4, alpha=0.2)
    np.testing.assert_array_equal(qc.lo, want.lo)
    np.testing.assert_array_equal(qc.hi, want.hi)


def test_estimator_updates_bump_versions_like_reference():
    wl = JaxOracleWorkload(num_classes=3, num_clusters=3, num_arms=4, seed=2)
    table, emb, _ = wl.response_table(150, seed=3)
    assign, _ = jclu.kmeans(emb, 3, seed=0)
    ref = jest.SuccessProbEstimator(table, emb, assign)
    port = tsp.SuccessProbEstimator(table, emb, assign)
    outcomes = (np.random.default_rng(0).random((9, 4)) < 0.7).astype(np.float64)
    for est in (ref, port):
        est.update(1, outcomes)
        est.update_counts(0, np.array([3.0, 0.0, 1.0, 2.0]), np.array([4.0, 0.0, 2.0, 2.0]),
                          queries=4)
        est.touch(2)
    assert (port.version, port.plan_version) == (ref.version, ref.plan_version) == (3, 3)
    for cid, st in ref.clusters.items():
        mine = port.clusters[cid]
        assert mine.version == st.version and mine.count == st.count
        for name in ("p_hat", "lo", "hi", "arm_counts"):
            np.testing.assert_array_equal(getattr(mine, name), getattr(st, name), err_msg=name)


@pytest.mark.parametrize("seed,L,K", [(0, 3, 2), (1, 4, 3), (2, 5, 4)])
def test_correctness_functions_bitwise(seed, L, K):
    p = np.random.default_rng(seed).uniform(0.2, 0.95, L)
    assert tcor.gamma(p) == jcor.gamma(p)
    assert tcor.gamma_marginal(p[0], p[1:]) == jcor.gamma_marginal(p[0], p[1:])
    assert tcor.xi_exact(p, K) == jcor.xi_exact(p, K)
    assert tcor.xi_exact(p[:2], K) == pytest.approx(tcor.xi_pair(p[0], p[1]), abs=1e-12)
    assert tcor.gamma(p) >= tcor.xi_exact(p, K) - 1e-12       # Lemma 3


def test_crn_estimator_converges_to_exact_xi():
    """The port's CRN estimator over many draws lies within a few standard
    errors of the exact enumeration, for several subsets of one pool."""
    p = np.array([0.55, 0.7, 0.8, 0.62])
    K, theta = 3, 8_000
    est = GroupedXiEstimator(prng.key(5, "cpu"), p[None], K, [theta], device="cpu")
    masks = np.array([[[1, 1, 1, 0], [1, 0, 1, 1], [1, 1, 1, 1]]], np.float32)
    got = est(masks).numpy()[0]
    for c, m in enumerate(masks[0]):
        want = tcor.xi_exact(p[m > 0], K, p_all=p)
        assert abs(got[c] - want) <= 4 * np.sqrt(want * (1 - want) / theta)


@pytest.mark.parametrize("seed,L", [(0, 6), (3, 10)])
def test_greedy_on_gamma_bitwise(seed, L):
    rng = np.random.default_rng(seed)
    p, b = rng.uniform(0.2, 0.95, L), rng.uniform(0.05, 1.0, L)
    budget = float(b.sum() * 0.4)
    want = jsel.greedy(p, b, budget, jsel.gamma_value_batch(p), 0.0)
    got = tsel.greedy(p, b, budget, tsel.gamma_value_batch(p), 0.0)
    assert got[0] == want[0] and got[1] == want[1]
    # the serial plane's survival-product greedy picks the same arms
    assert tsel._greedy_gamma(p, b, budget)[0] == got[0]


@pytest.mark.parametrize("use_rng", [False, True])
def test_adaptive_invoke_and_answer_bitwise(use_rng):
    rng = np.random.default_rng(11)
    L, K = 6, 4
    p, b = rng.uniform(0.3, 0.95, L), rng.uniform(0.05, 1.0, L)
    answers = rng.integers(0, K, (20, L))
    for q in range(answers.shape[0]):
        sel = list(rng.permutation(L)[: 1 + q % L])
        invoke = lambda arm: int(answers[q, arm])
        want = jsel.adaptive_invoke(sel, p, K, invoke, costs=b,
                                    rng=np.random.default_rng(q) if use_rng else None)
        got = tsel.adaptive_invoke(sel, p, K, invoke, costs=b,
                                   rng=np.random.default_rng(q) if use_rng else None)
        assert got.prediction == want.prediction
        np.testing.assert_array_equal(got.used, want.used)
        np.testing.assert_array_equal(got.responses, want.responses)
        np.testing.assert_array_equal(got.log_beliefs, want.log_beliefs)
        assert (got.cost, got.planned_cost) == (want.cost, want.planned_cost)
    ref = jsel.ThriftLLM(b, eps=0.5, delta=0.2, seed=2)
    port = tsel.ThriftLLM(b, eps=0.5, delta=0.2, seed=2, device="cpu")
    invoke = lambda arm: int(answers[0, arm])
    want = ref.answer(p, K, float(b.sum() * 0.5), invoke)
    got = port.answer(p, K, float(b.sum() * 0.5), invoke)
    assert got.prediction == want.prediction
    np.testing.assert_array_equal(got.used, want.used)
    np.testing.assert_array_equal(got.log_beliefs, want.log_beliefs)


def test_dbscan_and_auto_eps_bitwise():
    """``tests/test_estimation_data.py``'s cases (two blobs and an outlier;
    a positive eps) on both packages, plus DBSCAN at the eps the heuristic
    picks on a workload's embeddings."""
    rng = np.random.default_rng(2)
    a = rng.normal(0, 0.1, (40, 2))
    b = rng.normal(5, 0.1, (40, 2)) + np.array([5, 0])
    x = np.concatenate([a, b, np.array([[50.0, 50.0]])])
    labels = tclu.dbscan(x, eps=1.0, min_pts=4)
    np.testing.assert_array_equal(labels, jclu.dbscan(x, eps=1.0, min_pts=4))
    assert labels[-1] == -1 and labels[0] != labels[40]
    assert len(set(labels[:40])) == 1 and len(set(labels[40:80])) == 1
    y = np.random.default_rng(3).normal(0, 1, (100, 4))
    assert tclu.auto_eps(y) == jclu.auto_eps(y) > 0
    _, emb, _ = JaxOracleWorkload(num_classes=4, num_clusters=4, num_arms=5,
                                  seed=1).response_table(300, seed=7)
    eps = tclu.auto_eps(emb, q=0.05, sample=200, seed=4)
    assert eps == jclu.auto_eps(emb, q=0.05, sample=200, seed=4)
    np.testing.assert_array_equal(tclu.dbscan(emb, eps, min_pts=5, block=64),
                                  jclu.dbscan(emb, eps, min_pts=5, block=64))


@pytest.mark.parametrize("seed,G,L,K", [(0, 3, 5, 3), (1, 2, 8, 19)])
def test_public_grouped_xi_names_bitwise(seed, G, L, K):
    """``xi_from_responses_grouped`` (xi of arbitrary masks) and
    ``xi_marginal_grouped`` (xi of a set plus each arm) under the
    reference's public names, on the reference estimator's own draws."""
    rng = np.random.default_rng(seed)
    ps = rng.uniform(0.3, 0.95, (G, L))
    ref = jmc.GroupedXiEstimator(jax.random.key(seed), ps, K, rng.integers(150, 600, G))
    masks = (rng.random((G, 4, L)) < 0.5).astype(np.float32)
    T = ref.responses.shape[1]
    raw = np.zeros((G, T, K), np.float32)
    cnt = np.zeros((G, T, K), np.int32)
    for g in range(G):
        ref._accumulate(raw[g], cnt[g], g, [L - 1, 0])
    with jmc.enable_x64():
        want_x = np.asarray(jmc.xi_from_responses_grouped(
            ref.responses, masks, ref.log_weights, ref.empty, ref.valid, ref.theta_f,
            num_classes=K))
        want_m = np.asarray(jmc.xi_marginal_grouped(
            ref.responses_t, raw, cnt, ref.log_weights, ref.empty, ref.valid, ref.theta_f,
            num_classes=K))
    t = lambda a: torch.as_tensor(np.asarray(a))
    got_x = tcore.xi_from_responses_grouped(
        t(ref.responses), t(masks), t(ref.log_weights), t(ref.empty), t(ref.valid),
        t(ref.theta_f), num_classes=K)
    got_m = tcore.xi_marginal_grouped(
        t(ref.responses_t), t(raw), t(cnt), t(ref.log_weights), t(ref.empty), t(ref.valid),
        t(ref.theta_f), num_classes=K)
    assert got_x.dtype == got_m.dtype == torch.float64
    np.testing.assert_array_equal(got_x.numpy(), want_x)
    np.testing.assert_array_equal(got_m.numpy(), want_m)
