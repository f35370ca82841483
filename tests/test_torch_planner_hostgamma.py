"""The port's hostgamma planner plane (``_sur_greedy_many_hostgamma``) and the
``full=False`` surface of ``_sur_greedy_scan_core`` against the JAX package.

With ``use_kernel=False`` the baseline must equal the reference's baseline
and the port's fused ``sur_greedy_many`` bit for bit: picks, s1, s2, l*,
every xi, cost. With ``use_kernel=True`` the three candidates are scored
by ``mc_correctness_grouped`` (its plain version on the CPU: the exact
grouped core rounded once to f32), so the plans stay bitwise, every xi is
bitwise the f32 rounding of the fused plane's f64 value and bitwise the
port's serial plane under the kernel, and within 2e-6 of the reference's
interpret-mode kernel, which sums f32 credit in its own order. The card
against the CPU is ``test_torch_kernels_cuda.py``'s
``test_hostgamma_planner_on_card_matches_cpu_bitwise`` (a file without
JAX, for the card's machine).
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

from test_torch_planner import _case, assert_same

# test_hostgamma_baseline_equivalence's case, then seeds 0-3 of
# test_equivalence_grid: (seed, G, L, K, key)
CASES = [(33, 7, 8, 4, 21), (0, 1, 4, 2, 42), (1, 3, 6, 3, 42), (2, 8, 12, 4, 42),
         (3, 9, 12, 4, 42)]


def _plans_equal_but_xi(got, want):
    """Everything but the xi values bitwise (the kernel rounds xi to f32)."""
    assert np.array_equal(got.chosen, want.chosen)
    assert got.cost == want.cost and got.budget == want.budget
    assert (got.s1 is None) == (want.s1 is None)
    if got.s1 is not None:
        assert np.array_equal(got.s1, want.s1) and np.array_equal(got.s2, want.s2)
        assert got.l_star == want.l_star
        assert got.p_star == want.p_star and got.gamma_s2 == want.gamma_s2


def _xis(r):
    return [r.xi_est, r.xi_s1, r.xi_s2]


@pytest.mark.parametrize("seed,G,L,K,key", CASES)
def test_hostgamma_matches_reference_and_fused(seed, G, L, K, key):
    ps, b, budgets, thetas = _case(seed, G, L, K, 0.3, 2.5)
    want = jsel._sur_greedy_many_hostgamma(ps, b, budgets, K, jax.random.key(key), thetas)
    got = tsel._sur_greedy_many_hostgamma(ps, b, budgets, K, prng.key(key, "cpu"), thetas,
                                          device="cpu")
    fused = tsel.sur_greedy_many(ps, b, budgets, K, prng.key(key, "cpu"), thetas, device="cpu")
    fused_k = tsel.sur_greedy_many(ps, b, budgets, K, prng.key(key, "cpu"), thetas,
                                   use_kernel=True, device="cpu")
    for w, g, f, fk in zip(want, got, fused, fused_k):
        assert_same(w, g)
        assert_same(f, g)
        assert_same(fk, g)


@pytest.mark.parametrize("seed,G,L,K,key", CASES)
def test_hostgamma_use_kernel(seed, G, L, K, key):
    ps, b, budgets, thetas = _case(seed, G, L, K, 0.3, 2.5)
    want = jsel._sur_greedy_many_hostgamma(ps, b, budgets, K, jax.random.key(key), thetas,
                                           use_kernel=True)
    got = tsel._sur_greedy_many_hostgamma(ps, b, budgets, K, prng.key(key, "cpu"), thetas,
                                          use_kernel=True, device="cpu")
    fused = tsel.sur_greedy_many(ps, b, budgets, K, prng.key(key, "cpu"), thetas,
                                 use_kernel=True, device="cpu")
    for i, (w, g, f) in enumerate(zip(want, got, fused)):
        _plans_equal_but_xi(g, f)
        _plans_equal_but_xi(g, w)
        if g.s1 is None:
            assert_same(g, f)
            continue
        assert _xis(g) == [float(np.float32(x)) for x in _xis(f)]
        np.testing.assert_allclose(_xis(g), _xis(w), rtol=0, atol=2e-6)
        serial = tsel.sur_greedy(ps[i], b, float(budgets[i]), K, prng.key(key, "cpu"),
                                 int(thetas[i]), use_kernel=True, device="cpu")
        assert_same(serial, g)


def test_hostgamma_ragged_affordability():
    ps, b, budgets, thetas = _case(7, 6, 8, 4, 0.3, 1.5)
    budgets[1] = 0.0
    budgets[4] = float(b.min()) * 0.5
    want = jsel._sur_greedy_many_hostgamma(ps, b, budgets, 4, jax.random.key(3), thetas)
    got = tsel._sur_greedy_many_hostgamma(ps, b, budgets, 4, prng.key(3, "cpu"), thetas,
                                          device="cpu")
    for w, g in zip(want, got):
        assert_same(w, g)
    assert got[1].chosen.size == 0 and got[1].s1 is None and got[1].xi_est == 0.25


@pytest.mark.parametrize("seed,G,L,K,key", CASES)
def test_scan_core_full_false_surface(seed, G, L, K, key):
    """The six outputs of the phase-1 surface, bitwise the reference's."""
    ps, b, budgets, thetas = _case(seed, G, L, K, 0.3, 2.5)
    ps = tsel.clip_probs(ps)
    live = [g for g in range(G) if (b <= budgets[g] + 1e-15).any()]
    ref = jmc.GroupedXiEstimator(jax.random.key(key), ps[live], K, thetas[live])
    est = tmc.GroupedXiEstimator(prng.key(key, "cpu"), ps[live], K, thetas[live], device="cpu")
    n, L = ref.ps.shape
    with jax.experimental.enable_x64():
        want = jsel._sur_greedy_scan_nodonate(
            ref.responses_t, ref.valid, ref.log_weights, ref.empty, ref.theta_f, ref.ps,
            np.broadcast_to(b, (n, L)), budgets[live], np.exp(np.log1p(-ref.ps)),
            num_classes=K, full=False,
        )
        want = [np.asarray(w) for w in want]
    got = tsel._sur_greedy_scan_core(*tsel._stage_groups(est, b, budgets[live]),
                                     num_classes=K, full=False)
    assert len(got) == 6
    names = ("picks", "npick", "value", "spent", "base_raw", "base_cnt")
    for name, w, g in zip(names, want, got):
        g = g.numpy()
        assert g.dtype == w.dtype, name
        assert np.array_equal(g, w), name
    # the surface is the fused program's phase 1: its picks and counts
    full = tsel._sur_greedy_scan_core(*tsel._stage_groups(est, b, budgets[live]),
                                      num_classes=K)
    assert torch.equal(full[0], got[0]) and torch.equal(full[1], got[1])
