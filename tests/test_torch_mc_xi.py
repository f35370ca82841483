"""The port's single-pool CRN estimator against the JAX package:
``McXiEstimator``, ``xi_from_responses``, the plain version of the
``mc_correctness`` kernel, and GreedyLLM on Monte-Carlo xi (the paper's
Fig. 11 comparison, ``benchmarks/paper_benches.py::xi_vs_gamma``).

The draws, log weights and empty belief are bitwise the reference's. xi
itself is the port's exact form (integer tie credit, one division), which
differs from the reference's f32 mean by at most an f32 rounding: held to
1e-6, the reference's own tolerance for this kernel
(``tests/test_kernels.py``). The Pallas kernel runs in interpret mode, as
the JAX package's own tests run it. The kernel against its plain version on
a card is in ``test_torch_kernels_cuda.py``.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):      # removed in jax 0.9
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import correctness as jcor
from repro.core import mc as jmc
from repro.core import selection as jsel
from repro.kernels import ops as jops
from repro_torch.core import McXiEstimator, prng, theta_for, xi_exact, xi_from_responses
from repro_torch.core import selection as tsel
from repro_torch.kernels import mc_correctness as tmc_kernel
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

XI_ATOL = 1e-6

# (theta, L, C, K): tests/test_kernels.py's sweep, the Fig. 11 shape, and the
# serve defaults at K=77 (theta_for(0.1, 0.01, 0.5, 12) = 16843)
XI_SHAPES = [(512, 4, 3, 2), (1000, 8, 6, 5), (300, 12, 4, 17), (8000, 8, 8, 4),
             (16843, 12, 12, 77)]


def _pair(seed, p, K, theta, p_all=None):
    """The same estimator in both packages (port on the CPU)."""
    ref = jmc.McXiEstimator(jax.random.key(seed), p, K, theta, p_all=p_all)
    port = McXiEstimator(prng.key(seed, "cpu"), p, K, theta, p_all=p_all, device="cpu")
    return ref, port


@pytest.mark.parametrize("seed,L,K,theta,with_p_all", [
    (0, 4, 2, 512, False), (3, 8, 4, 8000, False), (5, 12, 77, 1000, True),
])
def test_estimator_state_bitwise(seed, L, K, theta, with_p_all):
    rng = np.random.default_rng(seed)
    p = rng.uniform(0.4, 0.95, L)
    p_all = np.concatenate([p, [0.31]]) if with_p_all else None
    ref, port = _pair(seed, p, K, theta, p_all)
    np.testing.assert_array_equal(port._responses.numpy(), np.asarray(ref._responses))
    np.testing.assert_array_equal(port._w.numpy(), np.asarray(ref._w))
    assert port._empty.dtype == torch.float32
    assert port._empty.item() == float(ref._empty)


@pytest.mark.parametrize("theta,L,C,K", XI_SHAPES)
def test_xi_matches_reference_and_pallas(theta, L, C, K):
    rng = np.random.default_rng(theta + L)
    p = rng.uniform(0.4, 0.95, L)
    ref, port = _pair(0, p, K, theta)
    masks = (rng.random((C, L)) < 0.6).astype(np.float32)
    masks[0] = 0.0                                       # the empty set too
    args = (port._responses, torch.as_tensor(masks), port._w, port._empty, K)
    got = xi_from_responses(*args).numpy()
    assert got.dtype == np.float32 and got.shape == (C,)
    np.testing.assert_array_equal(tops.mc_correctness(*args).numpy(), got)
    np.testing.assert_array_equal(tref.mc_correctness_ref(*args).numpy(), got)
    np.testing.assert_array_equal(port(masks), got)
    jargs = (ref._responses, jnp.asarray(masks), ref._w, ref._empty, K)
    np.testing.assert_allclose(got, np.asarray(jmc.xi_from_responses(*jargs)), rtol=0, atol=XI_ATOL)
    np.testing.assert_allclose(got, np.asarray(jops.mc_correctness(*jargs)), rtol=0, atol=XI_ATOL)


def test_kernel_backend_on_the_cpu_is_the_plain_version():
    """``use_kernel=True`` on a CPU device runs the wrapper's plain route:
    the same values, and no kernel launch counted."""
    p = np.array([0.9, 0.75, 0.6, 0.85, 0.55])
    masks = (np.random.default_rng(1).random((5, 5)) < 0.5).astype(np.float32)
    plain = McXiEstimator(prng.key(2, "cpu"), p, 3, 700, device="cpu")
    kern = McXiEstimator(prng.key(2, "cpu"), p, 3, 700, use_kernel=True, device="cpu")
    before = tops.mc_correctness.launches
    np.testing.assert_array_equal(kern(masks), plain(masks))
    assert tops.mc_correctness.launches == before


def test_reset_launch_counts_covers_mc_correctness():
    tops.mc_correctness.launches = 3
    tops.reset_launch_counts()
    assert tops.mc_correctness.launches == 0


def test_launch_validates_before_building():
    """Bad inputs are refused before the kernel is built."""
    resp = torch.zeros((300, 4), dtype=torch.int32)
    masks, w, empty = torch.ones((2, 4)), torch.zeros(4), torch.zeros(1)
    with pytest.raises(ValueError, match="K <= 32767"):
        tmc_kernel.launch(resp, masks, w, empty, 32768)
    with pytest.raises(ValueError, match="responses"):
        tmc_kernel.launch(resp.to(torch.int64), masks, w, empty, 4)
    with pytest.raises(ValueError, match="masks"):
        tmc_kernel.launch(resp, torch.ones((2, 5)), w, empty, 4)
    with pytest.raises(ValueError, match="empty"):
        tmc_kernel.launch(resp, masks, w, torch.zeros(()), 4)
    with pytest.raises(ValueError, match="T >= 1"):
        tmc_kernel.launch(resp[:0], masks, w, empty, 4)


# ---------------------------------------------------------------------------
# tests/test_core_selection.py's Monte-Carlo cases, on the port
# ---------------------------------------------------------------------------


def test_xi_empty_set():
    ref, port = _pair(0, np.array([0.9, 0.8]), 4, 20000)
    assert port.xi([]) == pytest.approx(0.25, abs=0.02)
    assert port.xi([]) == pytest.approx(ref.xi([]), abs=XI_ATOL)


@pytest.mark.parametrize("K", [2, 3, 7])
def test_mc_matches_exact(K):
    p = np.array([0.9, 0.75, 0.6, 0.85])
    ref, port = _pair(1, p, K, 150_000)
    got = port.xi(range(4))
    assert got == pytest.approx(xi_exact(p, K), abs=0.006)
    assert got == pytest.approx(ref.xi(range(4)), abs=XI_ATOL)


def test_lemma4_concentration():
    """|xi - xi_hat| <= eps*p*/2 holds across keys with theta from Alg 3."""
    p = np.array([0.9, 0.8, 0.7])
    K, eps = 3, 0.2
    theta = theta_for(eps, 0.01, 0.9, 3)
    exact = xi_exact(p, K)
    for s in range(10):
        ref, port = _pair(s, p, K, theta)
        got = port.xi(range(3))
        assert abs(got - exact) <= eps * 0.9 / 2
        assert got == pytest.approx(ref.xi(range(3)), abs=XI_ATOL)


# ---------------------------------------------------------------------------
# GreedyLLM on MC xi: the Fig. 11 setting, every seed
# ---------------------------------------------------------------------------


def _fig11_pools():
    """``xi_vs_gamma``'s 40 (p, b) pools, drawn in its order from one rng."""
    rng = np.random.default_rng(0)
    pools = []
    for _ in range(40):
        p = rng.uniform(0.4, 0.95, 8)
        pools.append((p, rng.uniform(0.1, 0.6, 8)))
    return pools


FIG11 = _fig11_pools()


@pytest.mark.parametrize("seed", range(40))
def test_greedy_on_mc_xi_picks_as_reference(seed):
    p, b = FIG11[seed]
    K = 4
    ref, port = _pair(seed, p, K, 8000)
    want, want_val = jsel.greedy(p, b, 1.0, ref, empty_value=1 / K)
    got, got_val = tsel.greedy(p, b, 1.0, port, empty_value=1 / K)
    assert got == want
    assert got_val == pytest.approx(want_val, abs=XI_ATOL)
    # the bench's derived quantity: exact xi of the pick against greedy on gamma
    g, _ = tsel.greedy(p, b, 1.0, tsel.gamma_value_batch(p), empty_value=0.0)
    jg, _ = jsel.greedy(p, b, 1.0, jsel.gamma_value_batch(p), empty_value=0.0)
    assert g == jg
    gain = ((xi_exact(p[got], K, p_all=p) if got else 1 / K)
            - (xi_exact(p[g], K, p_all=p) if g else 1 / K))
    want_gain = ((jcor.xi_exact(p[want], K, p_all=p) if want else 1 / K)
                 - (jcor.xi_exact(p[jg], K, p_all=p) if jg else 1 / K))
    assert gain == want_gain
