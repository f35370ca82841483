"""The paper's properties on both packages: the cases of the reference's
``test_properties.py`` (Lemmas 1-3, gamma submodular, the empty-class
heuristic), ``test_core_selection.py`` (``TestCorrectnessProbability``,
``TestGreedy``, ``TestAdaptive``, ``test_theta_formula``),
``test_serving.py`` and three cases of ``test_router_batched.py``, each
run once on the JAX package and once on the port (parameter ``pkg``).

Those reference files fail at collection on jax 0.9 (``enable_x64`` was
removed, ROADMAP F1) and are not edited; this file sets the alias before
importing ``repro``. The checks and their tolerances are the reference's.
The port runs on the CPU; its draws (``prng.key``) are the reference's
bit for bit, so where a case picks arms, the port's picks are also held
equal to the JAX package's.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):      # removed in jax 0.9
    jax.experimental.enable_x64 = jax.enable_x64

import dataclasses
import itertools

import numpy as np
import pytest

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # tier-1 container: see requirements-test.txt
    from _hypolite import given, settings, strategies as st

import repro.core as jcore
import repro.data as jdata
import repro.serving as jserving
import repro_torch.core as tcore
import repro_torch.data as tdata
import repro_torch.serving as tserving
from repro.core.clustering import kmeans as jkmeans
from repro_torch.core import prng
from repro_torch.core.clustering import kmeans as tkmeans

PKGS = ("jax", "port")
CORE = {"jax": jcore, "port": tcore}


def _sur_greedy(pkg, p, b, budget, K, seed, theta):
    if pkg == "jax":
        return jcore.sur_greedy(p, b, budget, K, jax.random.key(seed), theta=theta)
    res = tcore.sur_greedy(p, b, budget, K, prng.key(seed, "cpu"), theta=theta, device="cpu")
    want = jcore.sur_greedy(p, b, budget, K, jax.random.key(seed), theta=theta)
    np.testing.assert_array_equal(np.asarray(res.chosen), np.asarray(want.chosen))
    return res


# ---------------------------------------------------------------------------
# tests/test_properties.py
# ---------------------------------------------------------------------------

probs = st.lists(st.floats(0.05, 0.98), min_size=1, max_size=5)
klass = st.integers(2, 6)


def _better_than_random(ps, K, margin=0.02):
    return min(ps) > 1.0 / K + margin


@pytest.mark.parametrize("pkg", PKGS)
def test_gamma_upper_bounds_xi(pkg):
    """Lemma 3, for better-than-random arms."""
    c = CORE[pkg]

    @settings(max_examples=60, deadline=None)
    @given(probs, klass)
    def check(ps, K):
        if not _better_than_random(ps, K):
            return
        p = np.asarray(ps)
        assert c.gamma(p) >= c.xi_exact(p, K) - 1e-9

    check()


@pytest.mark.parametrize("pkg", PKGS)
def test_lemma3_fails_for_worse_than_random_arms(pkg):
    c = CORE[pkg]
    p = np.array([0.05, 0.05])
    assert c.xi_exact(p, 2) > 0.9
    assert c.gamma(p) < 0.1


@pytest.mark.parametrize("pkg", PKGS)
def test_xi_bounded_and_at_least_best_single(pkg):
    c = CORE[pkg]

    @settings(max_examples=60, deadline=None)
    @given(probs, klass)
    def check(ps, K):
        p = np.asarray(ps)
        x = c.xi_exact(p, K)
        assert -1e-9 <= x <= 1 + 1e-9
        if _better_than_random(ps, K):
            assert x >= max(p) - 1e-9

    check()


@pytest.mark.parametrize("pkg", PKGS)
def test_xi_monotone_in_probs(pkg):
    c = CORE[pkg]

    @settings(max_examples=40, deadline=None)
    @given(probs, klass, st.floats(0.0, 0.05))
    def check(ps, K, bump):
        if not _better_than_random(ps, K):
            return
        p = np.asarray(ps)
        hi = np.clip(p + bump, 0.0, 0.99)
        assert c.xi_exact(hi, K) >= c.xi_exact(p, K) - 1e-9

    check()


@pytest.mark.parametrize("pkg", PKGS)
def test_xi_monotone_in_set(pkg):
    c = CORE[pkg]

    @settings(max_examples=40, deadline=None)
    @given(probs, klass)
    def check(ps, K):
        if not _better_than_random(ps, K):
            return
        p = np.asarray(ps)
        if p.size < 2:
            return
        assert c.xi_exact(p, K, p_all=p) >= c.xi_exact(p[:-1], K, p_all=p) - 1e-9

    check()


@pytest.mark.parametrize("pkg", PKGS)
def test_lemma1_fails_for_worse_than_random_arms(pkg):
    c = CORE[pkg]
    p_all = np.array([0.0625, 0.0625, 0.125])
    smaller = c.xi_exact(p_all[:2], 3, p_all=p_all)
    larger = c.xi_exact(p_all, 3, p_all=p_all)
    assert larger < smaller


@pytest.mark.parametrize("pkg", PKGS)
def test_belief_aggregation_majority_of_identical_weights(pkg):
    """With equal weights, ML aggregation agrees with majority voting."""
    c = CORE[pkg]

    @settings(max_examples=50, deadline=None)
    @given(st.lists(st.integers(0, 4), min_size=1, max_size=8),
           st.lists(st.floats(0.2, 0.95), min_size=8, max_size=8))
    def check(resp, ps):
        K = 5
        p = np.full(len(resp), 0.7)
        w = c.log_weight(p, K)
        beliefs = c.aggregate_log_beliefs(np.asarray(resp), w, K, c.empty_log_belief(p))
        pred, _ = c.predict_from_beliefs(beliefs)
        votes = np.bincount(resp, minlength=K)
        assert votes[pred] == votes.max()

    check()


@pytest.mark.parametrize("pkg", PKGS)
def test_gamma_submodularity_random_chains(pkg):
    c = CORE[pkg]

    @settings(max_examples=50, deadline=None)
    @given(probs, klass)
    def check(ps, K):
        p = np.asarray(ps)
        if p.size < 3:
            return
        last = p.size - 1
        s1, s2 = p[:1], p[:-1]
        g1 = c.gamma(np.append(s1, p[last])) - c.gamma(s1)
        g2 = c.gamma(np.append(s2, p[last])) - c.gamma(s2)
        assert g1 >= g2 - 1e-12

    check()


@pytest.mark.parametrize("pkg", PKGS)
def test_empty_belief_below_any_arm_weight(pkg):
    """The empty-class heuristic never outranks a voted class with p > 1/2."""
    c = CORE[pkg]

    @settings(max_examples=30, deadline=None)
    @given(st.integers(2, 30), klass)
    def check(m, K):
        p = np.full(m, 0.6)
        assert c.empty_log_belief(p) < c.log_weight(p, K).min()

    check()


# ---------------------------------------------------------------------------
# tests/test_core_selection.py
# ---------------------------------------------------------------------------

def brute_force_oes(c, p, b, budget, K):
    """Exact optimum by enumerating all feasible subsets (small L only)."""
    L = len(p)
    best, best_set = 0.0, ()
    for r in range(L + 1):
        for S in itertools.combinations(range(L), r):
            if sum(b[i] for i in S) <= budget + 1e-12:
                v = c.xi_exact(np.asarray(p)[list(S)], K, p_all=p) if S else 1.0 / K
                if v > best:
                    best, best_set = v, S
    return best, best_set


class TestCorrectnessProbability:
    @pytest.mark.parametrize("pkg", PKGS)
    def test_prop2_pair_equals_max(self, pkg):
        c = CORE[pkg]
        rng = np.random.default_rng(0)
        for _ in range(20):
            p = rng.uniform(0.35, 0.98, 2)
            K = int(rng.integers(2, 8))
            assert c.xi_exact(p, K) == pytest.approx(max(p), abs=1e-9)
            assert c.xi_pair(*p) == max(p)

    @pytest.mark.parametrize("pkg", PKGS)
    def test_lemma1_monotone_in_probs(self, pkg):
        c = CORE[pkg]
        rng = np.random.default_rng(1)
        for _ in range(10):
            m, K = int(rng.integers(1, 5)), int(rng.integers(2, 5))
            p = rng.uniform(0.3, 0.9, m)
            hi = np.clip(p + rng.uniform(0, 0.08, m), 0, 0.99)
            assert c.xi_exact(hi, K) >= c.xi_exact(p, K) - 1e-9

    @pytest.mark.parametrize("pkg", PKGS)
    def test_lemma1_monotone_in_set(self, pkg):
        c = CORE[pkg]
        rng = np.random.default_rng(2)
        for _ in range(10):
            m, K = int(rng.integers(2, 5)), int(rng.integers(2, 5))
            p = rng.uniform(0.3, 0.9, m)
            assert c.xi_exact(p, K, p_all=p) >= c.xi_exact(p[:-1], K, p_all=p) - 1e-9

    @pytest.mark.parametrize("pkg", PKGS)
    def test_lemma2_non_submodular_counterexample(self, pkg):
        c = CORE[pkg]
        p1, p2, p3 = 0.90, 0.85, 0.85
        S, T = [p1], [p1, p2]
        gain_S = c.xi_exact(np.array(S + [p3]), 2) - c.xi_exact(np.array(S), 2)
        gain_T = c.xi_exact(np.array(T + [p3]), 2) - c.xi_exact(np.array(T), 2)
        assert gain_T > gain_S + 1e-6, "submodularity should be violated"

    @pytest.mark.parametrize("pkg", PKGS)
    def test_lemma3_gamma_upper_bounds_xi(self, pkg):
        c = CORE[pkg]
        rng = np.random.default_rng(3)
        for _ in range(30):
            m, K = int(rng.integers(1, 6)), int(rng.integers(2, 6))
            p = rng.uniform(0.2, 0.95, m)
            assert c.gamma(p) >= c.xi_exact(p, K) - 1e-9

    @pytest.mark.parametrize("pkg", PKGS)
    def test_gamma_submodular(self, pkg):
        c = CORE[pkg]
        rng = np.random.default_rng(4)
        for _ in range(30):
            probs_ = rng.uniform(0.1, 0.9, 6)
            s1, s2, last = [0, 1], [0, 1, 2, 3], 5
            g1 = c.gamma(probs_[s1 + [last]]) - c.gamma(probs_[s1])
            g2 = c.gamma(probs_[s2 + [last]]) - c.gamma(probs_[s2])
            assert g1 >= g2 - 1e-12

    @pytest.mark.parametrize("pkg", PKGS)
    def test_xi_empty_set(self, pkg):
        p = np.array([0.9, 0.8])
        if pkg == "jax":
            est = jcore.McXiEstimator(jax.random.key(0), p, 4, 20000)
        else:
            est = tcore.McXiEstimator(prng.key(0, "cpu"), p, 4, 20000, device="cpu")
        assert est.xi([]) == pytest.approx(0.25, abs=0.02)


@pytest.mark.parametrize("pkg", PKGS)
def test_theta_formula(pkg):
    th = CORE[pkg].theta_for(0.1, 0.01, 0.9, 12)
    expect = (8 + 2 * 0.1) / (0.1 ** 2 * 0.9) * np.log(2 * 144 / 0.01)
    assert th == int(np.ceil(expect))


class TestGreedy:
    @pytest.mark.parametrize("pkg", PKGS)
    def test_vanilla_greedy_can_be_arbitrarily_bad(self, pkg):
        """Paper Section 4.2: ratio-greedy picks the cheap weak arm."""
        c = CORE[pkg]
        p, b = np.array([0.9, 0.2]), np.array([1.0, 0.001])
        chosen, _ = c.greedy(p, b, 1.0, c.gamma_value_batch(p), empty_value=0.0)
        assert chosen[0] == 1

    @pytest.mark.parametrize("pkg", PKGS)
    def test_sur_greedy_beats_vanilla_trap(self, pkg):
        p, b = np.array([0.9, 0.2]), np.array([1.0, 0.001])
        res = _sur_greedy(pkg, p, b, 1.0, 2, seed=0, theta=20_000)
        assert 0 in list(res.chosen)                 # best single arm rescued via l*
        assert res.xi_est >= 0.85

    @pytest.mark.parametrize("pkg", PKGS)
    def test_budget_respected(self, pkg):
        rng = np.random.default_rng(5)
        for s in range(5):
            p = rng.uniform(0.4, 0.95, 6)
            b = rng.uniform(0.1, 1.0, 6)
            budget = float(rng.uniform(0.3, 2.0))
            res = _sur_greedy(pkg, p, b, budget, 3, seed=s, theta=5_000)
            assert res.cost <= budget + 1e-9

    @pytest.mark.parametrize("pkg", PKGS)
    def test_theorem3_bound_holds_vs_bruteforce(self, pkg):
        c = CORE[pkg]
        rng = np.random.default_rng(6)
        for s in range(5):
            L, K = 5, 3
            p = rng.uniform(0.4, 0.95, L)
            b = rng.uniform(0.1, 0.6, L)
            res = _sur_greedy(pkg, p, b, 1.0, K, seed=s, theta=40_000)
            opt, _ = brute_force_oes(c, p, b, 1.0, K)
            xi_star = c.xi_exact(p[res.chosen], K, p_all=p) if len(res.chosen) else 1 / K
            bound = res.approx_ratio_bound * (1 - 1 / np.sqrt(np.e)) * opt
            assert xi_star >= bound - 0.02              # eps-slack for MC noise


class TestAdaptive:
    @staticmethod
    def _roll(p, K, truth, seed):
        r = np.random.default_rng(seed)

        def invoke(i):
            if r.random() < p[i]:
                return truth
            return int((truth + 1 + r.integers(K - 1)) % K)

        return invoke

    @pytest.mark.parametrize("pkg", PKGS)
    def test_prop4_prediction_equality(self, pkg):
        c = CORE[pkg]
        p = np.array([0.9, 0.8, 0.7, 0.6, 0.85, 0.75])
        b = np.ones(6) * 0.2
        K = 4
        res = _sur_greedy(pkg, p, b, 1.0, K, seed=0, theta=10_000)
        order = sorted(res.chosen, key=lambda i: -p[i])
        for s in range(200):
            inv = c.adaptive_invoke(list(res.chosen), p, K, self._roll(p, K, 2, s), costs=b)
            r2 = np.random.default_rng(s)
            full = [2 if r2.random() < p[i] else int((3 + r2.integers(K - 1)) % K)
                    for i in order]
            assert inv.prediction == c.aggregate_predict(np.asarray(full), p[order], K, p_all=p)

    @pytest.mark.parametrize("pkg", PKGS)
    def test_adaptive_cost_never_exceeds_planned(self, pkg):
        c = CORE[pkg]
        p = np.array([0.9, 0.8, 0.7, 0.6])
        b = np.array([0.4, 0.3, 0.2, 0.1])
        for s in range(50):
            inv = c.adaptive_invoke([0, 1, 2, 3], p, 3, self._roll(p, 3, 1, s), costs=b)
            assert inv.cost <= inv.planned_cost + 1e-12

    @pytest.mark.parametrize("pkg", PKGS)
    def test_adaptive_saves_cost_on_easy_queries(self, pkg):
        c = CORE[pkg]
        p = np.array([0.97, 0.96, 0.95, 0.94, 0.93])
        b = np.ones(5)
        savings = []
        for s in range(100):
            inv = c.adaptive_invoke([0, 1, 2, 3, 4], p, 2, self._roll(p, 2, 0, s), costs=b)
            savings.append(1 - inv.cost / inv.planned_cost)
        assert np.mean(savings) > 0.2


# ---------------------------------------------------------------------------
# tests/test_serving.py
# ---------------------------------------------------------------------------

def _pkg_modules(pkg):
    """(data, serving, kmeans, estimator class, router kwargs) of a package."""
    if pkg == "jax":
        return jdata, jserving, jkmeans, jcore.SuccessProbEstimator, {}
    return tdata, tserving, tkmeans, tcore.SuccessProbEstimator, {"device": "cpu"}


@pytest.fixture(scope="module", params=PKGS)
def setup(request):
    data, serving, kmeans, Estimator, kw = _pkg_modules(request.param)
    wl = data.OracleWorkload(num_classes=4, num_clusters=5, num_arms=8, seed=3)
    T, emb, cid = wl.response_table(600)
    assign, _ = kmeans(emb, 5, seed=0)
    est = Estimator(T, emb, assign)
    engine = serving.PoolEngine([serving.OracleArm(f"a{i}", wl, i, seed=11) for i in range(8)])
    router = serving.ThriftRouter(engine, est, num_classes=4, **kw)
    return wl, est, engine, router, serving


def _queries(wl, n, seed=42):
    rng = np.random.default_rng(seed)
    cid, emb, lab = wl.sample_queries(n, rng)
    return list(zip(cid, lab)), emb, lab


def test_router_respects_per_query_budget(setup):
    wl, est, engine, router, _ = setup
    queries, emb, lab = _queries(wl, 200)
    for budget in np.quantile(engine.costs, [0.2, 0.5, 0.9]):
        res = router.route_batch(queries, emb, float(budget) * 2)
        assert (res.costs <= float(budget) * 2 + 1e-12).all()
        assert (res.costs <= res.planned_costs + 1e-12).all()


def test_router_beats_cheapest_single_arm(setup):
    wl, est, engine, router, _ = setup
    queries, emb, lab = _queries(wl, 400)
    budget = float(np.quantile(engine.costs, 0.7)) * 2
    res = router.route_batch(queries, emb, budget)
    acc = (res.predictions == lab).mean()
    rng = np.random.default_rng(9)
    cheap = np.argmin(engine.costs)
    acc_cheap = np.mean([wl.invoke(int(cheap), int(c), int(l), rng) == l for c, l in queries])
    assert acc > acc_cheap + 0.02


def test_router_accuracy_tracks_xi_estimate(setup):
    wl, est, engine, router, _ = setup
    queries, emb, lab = _queries(wl, 500)
    budget = float(np.quantile(engine.costs, 0.8)) * 3
    res = router.route_batch(queries, emb, budget)
    assert (res.predictions == lab).mean() > 0.85


def test_wavefront_stops_early_on_consensus(setup):
    wl, est, engine, router, _ = setup
    queries, emb, lab = _queries(wl, 200)
    res = router.route_batch(queries, emb, float(engine.costs.sum()))
    n_used = np.array([len(a) for a in res.arms_used])
    assert (res.costs <= res.planned_costs + 1e-12).all()
    assert n_used.mean() > 0


def test_scheduler_batches_and_routes(setup):
    wl, est, engine, router, serving = setup
    queries, emb, lab = _queries(wl, 64)
    sched = serving.BatchScheduler(router, max_batch=16, max_wait_s=0.0)
    budget = float(np.quantile(engine.costs, 0.6)) * 2
    for q, e in zip(queries, emb):
        sched.submit(serving.Request(payload=q, embedding=e, budget=budget))
    total = 0
    while sched.ready():
        for group, res in sched.flush():
            total += len(group)
            assert (res.costs <= budget + 1e-12).all()
    assert total == 64
    assert sched.stats["batches"] == 4


def test_straggler_hedge_plan(setup):
    router, serving = setup[3], setup[4]
    assert serving.BatchScheduler(router).mitigator.hedge_plan([3, 1, 5], slow_arm=1) == [3, 5, 1]


# ---------------------------------------------------------------------------
# tests/test_router_batched.py: the three cases no port test drove
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class TabularArm:
    """Deterministic arm: response to query j is the precomputed resp[j]."""

    name: str
    cost: float
    resp: np.ndarray

    def classify_batch(self, queries) -> np.ndarray:
        return self.resp[np.asarray(queries, np.int64)]

    def latency_s(self, batch: int) -> float:
        return 1e-6 * self.cost * batch


def _symmetric_router(pkg, p_sym=0.8, N=200):
    """Two equal-cost, equal-p arms that always vote class 0 and class 1:
    every routed query ends in an exact belief tie."""
    _, serving, _, Estimator, kw = _pkg_modules(pkg)
    table = np.zeros((N, 2))
    table[: int(N * p_sym)] = 1.0
    est = Estimator(table, np.zeros((N, 4)), np.zeros(N, np.int64))
    B = 64
    engine = serving.PoolEngine([TabularArm("zero", 1.0, np.zeros(B, np.int64)),
                                 TabularArm("one", 1.0, np.ones(B, np.int64))])
    router = serving.ThriftRouter(engine, est, num_classes=2, **kw)
    budget = 2.0
    p = est.clusters[list(est.clusters)[0]].p_hat
    key = (np.round(np.asarray(p, np.float64), 12).tobytes(), 2, budget)
    result = jcore.SelectionResult if pkg == "jax" else tcore.SelectionResult
    router.selector._cache[key] = result(chosen=np.asarray([0, 1], np.int64), xi_est=p_sym,
                                         cost=2.0, budget=budget)
    return router, np.zeros((B, 4)), budget, B


@pytest.mark.parametrize("pkg", PKGS)
def test_tie_break_regression_symmetric_pool(pkg):
    """Seed bug: bare np.argmax biased every tied query to class 0."""
    router, qemb, budget, B = _symmetric_router(pkg)
    res = router.route_batch(np.arange(B), qemb, budget, rng=np.random.default_rng(0))
    assert all(len(a) == 2 for a in res.arms_used)
    assert 0.25 < float(np.mean(res.predictions == 0)) < 0.75
    res_det = router.route_batch(np.arange(B), qemb, budget)
    assert (res_det.predictions == 0).all()


@pytest.mark.parametrize("pkg", PKGS)
def test_tie_break_helper_scalar_and_batch(pkg):
    tie_break_argmax = CORE[pkg].tie_break_argmax
    beliefs = np.array([[1.0, 1.0, 0.5], [0.2, 0.9, 0.9]])
    pred, ties = tie_break_argmax(beliefs)
    np.testing.assert_array_equal(pred, [0, 1])
    np.testing.assert_array_equal(ties, [2, 2])
    rng = np.random.default_rng(1)
    draws = [int(tie_break_argmax(beliefs[0], rng)[0]) for _ in range(300)]
    assert set(draws) == {0, 1}
    assert 0.4 < np.mean(draws) < 0.6


@pytest.mark.parametrize("pkg", PKGS)
def test_scheduler_group_accounting_and_used_arm_latency(pkg):
    data, serving, kmeans, Estimator, kw = _pkg_modules(pkg)
    wl = data.OracleWorkload(num_classes=4, num_clusters=4, num_arms=8, seed=3)
    T, emb, _ = wl.response_table(400)
    assign, _ = kmeans(emb, 4, seed=0)
    est = Estimator(T, emb, assign)
    engine = serving.PoolEngine([serving.OracleArm(f"a{i}", wl, i, seed=11) for i in range(8)])
    router = serving.ThriftRouter(engine, est, num_classes=4, **kw)
    sched = serving.BatchScheduler(router, max_batch=16, max_wait_s=0.0)
    cid, qemb, lab = wl.sample_queries(16, np.random.default_rng(5))
    lo = float(np.quantile(engine.costs, 0.3)) * 2
    hi = float(np.quantile(engine.costs, 0.8)) * 2
    for i in range(16):
        sched.submit(serving.Request(payload=(cid[i], lab[i]), embedding=qemb[i],
                                     budget=lo if i % 2 == 0 else hi))
    out = sched.flush()
    assert len(out) == 1
    batch, res = out[0]
    assert len(batch) == 16
    assert sched.stats["batches"] == 2
    assert sched.stats["flushes"] == 1
    lat = sched.mitigator.history[-1]
    unused = res.arm_query_counts == 0
    assert (lat[unused] == 0.0).all()
    assert (lat[~unused] > 0.0).all()
    budgets = np.asarray([r.budget for r in batch])
    assert (res.costs <= budgets + 1e-12).all()
