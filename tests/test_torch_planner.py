"""The port's estimator and serial planner against the JAX package.

Under the same CRN seed, ``GroupedXiEstimator.marginal``/``final_xi`` and
``sur_greedy`` must equal the reference bit for bit: chosen sets, pick
order, every xi, ``l_star``, cost and the s1/s2 sets. With
``use_kernel=True`` on both sides the candidates are scored by the
``mc_correctness_grouped`` kernels, which sum f32 credit in their own
orders: the chosen sets must still be equal and the three candidate xi
values within 2e-6. The batched planner is in
``test_torch_planner_batched.py``.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):      # removed in jax 0.9
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np
import pytest
import torch

from repro.core import mc as jmc
from repro.core import selection as jsel
from repro_torch.core import mc as tmc
from repro_torch.core import prng
from repro_torch.core import selection as tsel


def _case(seed, G, L, K, budget_lo, budget_hi):
    rng = np.random.default_rng(seed)
    ps = rng.uniform(0.2, 0.98, (G, L))
    b = rng.uniform(0.05, 1.0, L)
    budgets = rng.uniform(budget_lo, budget_hi, G)
    thetas = rng.integers(120, 700, G)
    return ps, b, budgets, thetas


def assert_same(s, m):
    """Bitwise equality of everything the planner derives."""
    assert np.array_equal(s.chosen, m.chosen)
    assert s.xi_est == m.xi_est and s.cost == m.cost and s.budget == m.budget
    assert (s.s1 is None) == (m.s1 is None)
    if s.s1 is not None:
        assert np.array_equal(s.s1, m.s1) and np.array_equal(s.s2, m.s2)
        assert s.l_star == m.l_star
        assert s.xi_s1 == m.xi_s1 and s.xi_s2 == m.xi_s2
        assert s.p_star == m.p_star and s.gamma_s2 == m.gamma_s2


@pytest.mark.parametrize("seed,G,L,K", [(0, 3, 5, 3), (1, 2, 8, 19)])
def test_estimator_marginal_and_final_xi_bitwise(seed, G, L, K):
    rng = np.random.default_rng(seed)
    ps = rng.uniform(0.3, 0.95, (G, L))
    thetas = rng.integers(150, 600, G)
    ref = jmc.GroupedXiEstimator(jax.random.key(seed), ps, K, thetas)
    est = tmc.GroupedXiEstimator(prng.key(seed, "cpu"), ps, K, thetas, device="cpu")
    T = ref.responses.shape[1]
    raw = np.zeros((G, T, K), np.float32)
    cnt = np.zeros((G, T, K), np.int32)
    for g in range(G):
        ref._accumulate(raw[g], cnt[g], g, [L - 1, 0])     # pick order, not sorted
    got = est.marginal(torch.as_tensor(raw), torch.as_tensor(cnt))
    assert got.dtype == torch.float64
    np.testing.assert_array_equal(got.numpy(), ref.marginal(raw, cnt))
    l_stars = [g % L for g in range(G)]
    s1s = [[L - 1, 0]] * G
    s2s = [[1, 2], [], [0, 3]][:G]
    want = ref.final_xi(l_stars, s1s, s2s, raw, cnt)
    np.testing.assert_array_equal(
        est.final_xi(l_stars, s1s, s2s, torch.as_tensor(raw), torch.as_tensor(cnt)).numpy(), want
    )
    masks = (rng.random((G, 4, L)) < 0.5).astype(np.float32)
    np.testing.assert_array_equal(est(masks).numpy(), ref(masks))


@pytest.mark.parametrize("seed,G,L,K", [(0, 1, 4, 2), (3, 2, 12, 4), (4, 2, 8, 7)])
def test_sur_greedy_bitwise(seed, G, L, K):
    ps, b, budgets, thetas = _case(seed, G, L, K, 0.3, 2.5)
    for g in range(G):
        want = jsel.sur_greedy(ps[g], b, float(budgets[g]), K, jax.random.key(42), int(thetas[g]))
        got = tsel.sur_greedy(ps[g], b, float(budgets[g]), K, prng.key(42, "cpu"),
                              int(thetas[g]), device="cpu")
        assert_same(want, got)


def test_sur_greedy_nothing_affordable():
    ps, b, _, thetas = _case(31, 1, 7, 4, 0.5, 2.0)
    got = tsel.sur_greedy(ps[0], b, float(b.min()) * 0.25, 4, prng.key(9, "cpu"),
                          int(thetas[0]), device="cpu")
    want = jsel.sur_greedy(ps[0], b, float(b.min()) * 0.25, 4, jax.random.key(9), int(thetas[0]))
    assert_same(want, got)
    assert got.chosen.size == 0 and got.s1 is None and got.xi_est == 0.25


@pytest.mark.parametrize("seed,G,L,K", [(2, 3, 12, 4), (4, 2, 8, 7)])
def test_sur_greedy_kernel_backend(seed, G, L, K):
    ps, b, budgets, thetas = _case(seed, G, L, K, 0.3, 2.5)
    for g in range(G):
        want = jsel.sur_greedy(ps[g], b, float(budgets[g]), K, jax.random.key(42),
                               int(thetas[g]), use_kernel=True)
        got = tsel.sur_greedy(ps[g], b, float(budgets[g]), K, prng.key(42, "cpu"),
                              int(thetas[g]), use_kernel=True, device="cpu")
        assert np.array_equal(want.chosen, got.chosen)
        assert np.array_equal(want.s1, got.s1) and np.array_equal(want.s2, got.s2)
        assert want.l_star == got.l_star
        np.testing.assert_allclose(
            [got.xi_est, got.xi_s1, got.xi_s2], [want.xi_est, want.xi_s1, want.xi_s2],
            rtol=0, atol=2e-6,
        )


def test_thrift_llm_select_matches_reference_and_shares_cache():
    ps, b, budgets, _ = _case(9, 3, 8, 4, 0.4, 2.0)
    ref = jsel.ThriftLLM(b, eps=0.5, delta=0.2, seed=1)
    port = tsel.ThriftLLM(b, eps=0.5, delta=0.2, seed=1, device="cpu")
    serial = [port.select(ps[g], 4, float(budgets[g])) for g in range(3)]
    for g in range(3):
        assert_same(ref.select(ps[g], 4, float(budgets[g])), serial[g])
    # batched selection of the same pairs is a pure cache hit
    assert all(a is b for a, b in zip(port.select_many(ps, 4, budgets), serial))
