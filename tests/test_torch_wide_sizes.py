"""The port's kernels past the sizes their first CUDA versions took (32 arms,
128 classes) and past the limits of later ones (1024 arms, 32767 classes),
held to the JAX package, which takes any: the plain versions
(the kernels' CPU route) against the Pallas kernels in interpret mode, as
the JAX package's own tests run them, and against its oracles.

Tolerances are the reference's own (``tests/test_kernels.py``): beliefs to
1e-6 with equal predictions, grouped xi to 2e-6 against the Pallas kernel
and bitwise against the exact f64 oracle, single-pool xi to 1e-6. The CUDA
kernels at these sizes against their plain versions, on a card, are in
``test_torch_kernels_cuda.py``.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):      # removed in jax 0.9
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mc as jmc
from repro.core.mc import GroupedXiEstimator as JaxGroupedXiEstimator
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.belief_aggregate import belief_aggregate_pallas
from repro_torch.core import McXiEstimator, prng
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

from _torch_serving import one_torch_thread  # noqa: F401  (autouse: torch on one CPU thread)

XI_ATOL = 1e-6


@pytest.mark.parametrize("K", [129, 200])
def test_belief_aggregate_plain_matches_pallas_past_128_classes(K):
    B, M = 37, 40
    rng = np.random.default_rng(K)
    responses = rng.integers(-1, K, (B, M)).astype(np.int32)
    responses[:, :M // 2] = rng.integers(0, 3, (B, M // 2))   # ties and repeat votes too
    w = rng.uniform(0.3, 3.0, (B, M)).astype(np.float32)
    empty = rng.uniform(-3.0, -0.5, B).astype(np.float32)
    bel, pred = tref.belief_aggregate_ref(
        torch.as_tensor(responses), torch.as_tensor(w), torch.as_tensor(empty), K)
    assert bel.shape == (B, K) and pred.shape == (B,)
    jargs = (jnp.asarray(responses), jnp.asarray(w), jnp.asarray(empty), K)
    for wb, wp in (belief_aggregate_pallas(*jargs, interpret=True), jref.belief_aggregate_ref(*jargs)):
        np.testing.assert_allclose(bel.numpy(), np.asarray(wb), rtol=0, atol=1e-6)
        np.testing.assert_array_equal(pred.numpy(), np.asarray(wp))


# (G, theta, L, K, C): pools past 32 arms, 150 classes
WIDE_GROUPED = [(2, 300, 33, 150, 3), (3, 400, 40, 150, 4)]


@pytest.mark.parametrize("G,theta,L,K,C", WIDE_GROUPED)
def test_grouped_plain_xi_matches_jax_on_wide_pools(G, theta, L, K, C):
    rng = np.random.default_rng(theta + L)
    ps = rng.uniform(0.4, 0.95, (G, L))
    thetas = rng.integers(theta // 2, theta + 1, G)
    est = JaxGroupedXiEstimator(jax.random.key(1), ps, K, thetas)
    masks = (rng.random((G, C, L)) < 0.6).astype(np.float32)
    masks[:, -1] = 0.0                                   # the empty set too
    got = tops.mc_correctness_grouped(
        torch.as_tensor(est.responses), torch.as_tensor(masks),
        torch.as_tensor(est.log_weights), torch.as_tensor(est.empty),
        torch.as_tensor(est.valid), torch.as_tensor(est.theta_f.astype(np.float32)), K,
    ).numpy()
    assert got.dtype == np.float32 and got.shape == (G, C)
    pallas = jops.mc_correctness_grouped(
        jnp.asarray(est.responses), jnp.asarray(masks), jnp.asarray(est.log_weights),
        jnp.asarray(est.empty), jnp.asarray(est.valid), jnp.asarray(est.theta_f, jnp.float32), K,
    )
    np.testing.assert_allclose(got, np.asarray(pallas), rtol=0, atol=2e-6)
    oracle = jref.mc_correctness_grouped_ref(
        est.responses, masks, est.log_weights, est.empty, est.valid, est.theta_f, K,
    )
    np.testing.assert_array_equal(got, np.asarray(oracle))


# (theta, L, C, K)
WIDE_SINGLE = [(500, 33, 4, 150), (600, 40, 5, 150)]


@pytest.mark.parametrize("theta,L,C,K", WIDE_SINGLE)
def test_single_pool_plain_xi_matches_jax_on_wide_pools(theta, L, C, K):
    rng = np.random.default_rng(theta + L)
    p = rng.uniform(0.4, 0.95, L)
    ref = jmc.McXiEstimator(jax.random.key(3), p, K, theta)
    port = McXiEstimator(prng.key(3, "cpu"), p, K, theta, device="cpu")
    np.testing.assert_array_equal(port._responses.numpy(), np.asarray(ref._responses))
    masks = (rng.random((C, L)) < 0.6).astype(np.float32)
    masks[0] = 0.0                                       # the empty set too
    args = (port._responses, torch.as_tensor(masks), port._w, port._empty, K)
    got = tops.mc_correctness(*args).numpy()
    assert got.dtype == np.float32 and got.shape == (C,)
    np.testing.assert_array_equal(tref.mc_correctness_ref(*args).numpy(), got)
    jargs = (ref._responses, jnp.asarray(masks), ref._w, ref._empty, K)
    np.testing.assert_allclose(got, np.asarray(jmc.xi_from_responses(*jargs)), rtol=0, atol=XI_ATOL)
    np.testing.assert_allclose(got, np.asarray(jops.mc_correctness(*jargs)), rtol=0, atol=XI_ATOL)



def _lifted(G, theta, L, K, C):
    rng = np.random.default_rng(L + K)
    resp = rng.integers(-1, K, (G, theta, L)).astype(np.int32)
    resp[:, :, : L // 2] = rng.integers(-1, 3, (G, theta, L // 2))   # votes on class 0 too
    masks = (rng.random((G, C, L)) < 0.6).astype(np.float32)
    masks[:, -1] = 0.0                                   # the empty set too
    w = rng.uniform(0.3, 3.0, (G, L)).astype(np.float32)
    empty = rng.uniform(-3.0, -0.5, G).astype(np.float32)
    return resp, masks, w, empty


def test_grouped_plain_xi_matches_jax_past_1024_arms():
    """1100 arms, past the 1024 the CUDA kernels once took: the port's
    grouped xi (the kernels' CPU route) bitwise the JAX package's grouped
    oracle, run op by op (its arm chain unrolled 1100 times would take
    long to compile), at a small theta with a ragged last draw."""
    G, theta, L, K, C = 1, 4, 1100, 4, 3
    resp, masks, w, empty = _lifted(G, theta, L, K, C)
    valid = np.ones((G, theta), np.float32)
    valid[:, -1] = 0.0
    theta_f = np.full(G, theta - 1, np.float64)
    got = tops.mc_correctness_grouped(
        *(torch.as_tensor(a) for a in (resp, masks, w, empty, valid, theta_f.astype(np.float32))),
        K,
    ).numpy()
    assert got.dtype == np.float32 and got.shape == (G, C)
    with jax.disable_jit(), jax.check_tracer_leaks(False):
        oracle = jref.mc_correctness_grouped_ref(resp, masks, w, empty, valid, theta_f, K)
    np.testing.assert_array_equal(got, np.asarray(oracle))


@pytest.mark.parametrize("L,K", [(64, 40000), (1100, 40000)])
def test_plain_xi_matches_jax_past_32767_classes(L, K):
    """40000 classes, past the 32767 the CUDA kernels once took: the port's
    single-pool xi within the reference's 1e-6 of the JAX oracle, and
    bitwise its grouped xi at G=1 (one body serves both kernels)."""
    theta, C = 2, 3
    resp, masks, w, empty = _lifted(1, theta, L, K, C)
    args = (torch.as_tensor(resp[0]), torch.as_tensor(masks[0]), torch.as_tensor(w[0]),
            torch.as_tensor(empty[:1]), K)
    got = tops.mc_correctness(*args).numpy()
    assert got.dtype == np.float32 and got.shape == (C,)
    grouped = tops.mc_correctness_grouped(
        torch.as_tensor(resp), torch.as_tensor(masks), torch.as_tensor(w),
        torch.as_tensor(empty), torch.ones((1, theta)), torch.tensor([float(theta)]), K,
    ).numpy()
    np.testing.assert_array_equal(got, grouped[0])
    want = jmc.xi_from_responses(jnp.asarray(resp[0]), jnp.asarray(masks[0]),
                                 jnp.asarray(w[0]), jnp.float32(empty[0]), K)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=XI_ATOL)
