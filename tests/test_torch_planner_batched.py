"""The port's batched planner (``sur_greedy_many``) against the JAX package.

Over the seed grids of ``tests/test_selection_batched.py`` the port's
batched plane must equal the reference's batched plane bit for bit, and
the port's own serial plane group by group (the reference pins its serial
plane to its batched one, so this closes the chain serial == serial).
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):      # removed in jax 0.9
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np
import pytest

from repro.core import selection as jsel
from repro_torch.core import prng
from repro_torch.core import selection as tsel

from test_torch_planner import _case, assert_same


def _check(ps, b, budgets, K, seed, thetas, serial=True):
    want = jsel.sur_greedy_many(ps, b, budgets, K, jax.random.key(seed), thetas, donate=False)
    got = tsel.sur_greedy_many(ps, b, budgets, K, prng.key(seed, "cpu"), thetas, device="cpu")
    for w, g in zip(want, got):
        assert_same(w, g)
    if serial:
        for i in range(len(budgets)):
            one = tsel.sur_greedy(ps[i], b, float(budgets[i]), K, prng.key(seed, "cpu"),
                                  int(thetas[i]), device="cpu")
            assert_same(one, got[i])
    return got


@pytest.mark.parametrize(
    "seed,G,L,K",
    [
        (0, 1, 4, 2),      # single group == the serial plane
        (1, 3, 6, 3),
        (2, 8, 12, 4),     # a full group bucket in the reference
        (3, 9, 12, 4),     # ragged G
        (4, 5, 8, 7),
        (5, 4, 6, 19),     # big-K histogram branch
    ],
)
def test_equivalence_grid(seed, G, L, K):
    ps, b, budgets, thetas = _case(seed, G, L, K, 0.3, 2.5)
    _check(ps, b, budgets, K, 42, thetas, serial=G <= 3)


@pytest.mark.parametrize("seed,G,L,budget_lo,budget_hi", [(21, 3, 8, 0.2, 0.8), (23, 9, 10, 0.3, 3.5)])
def test_fused_gamma_plane_grid(seed, G, L, budget_lo, budget_hi):
    ps, b, budgets, thetas = _case(seed, G, L, 4, budget_lo, budget_hi)
    _check(ps, b, budgets, 4, 5, thetas, serial=False)


def test_ragged_affordability():
    ps, b, budgets, thetas = _case(7, 6, 8, 4, 0.3, 1.5)
    budgets[1] = 0.0
    budgets[4] = float(b.min()) * 0.5
    got = _check(ps, b, budgets, 4, 3, thetas, serial=False)
    assert got[1].chosen.size == 0 and got[1].s1 is None and got[1].xi_est == 0.25


def test_exact_gamma_ties():
    """Duplicated (p, b) columns: every gamma round is an exact ratio tie."""
    rng = np.random.default_rng(30)
    ps_half = rng.uniform(0.3, 0.9, (4, 5))
    ps = np.concatenate([ps_half, ps_half], axis=1)
    b_half = rng.uniform(0.1, 0.8, 5)
    b = np.concatenate([b_half, b_half])
    budgets = rng.uniform(0.5, 3.0, 4)
    thetas = rng.integers(150, 500, 4)
    _check(ps, b, budgets, 3, 8, thetas, serial=False)
