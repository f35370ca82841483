"""The port's CRN draws are the JAX package's, bit for bit.

``repro_torch.core.prng`` emulates jax's partitionable threefry2x32 in
torch integer ops; the samplers built on it must reproduce
``repro.core.mc.sample_pool_responses`` / ``_grouped`` exactly, or no plan
could be compared across the packages.
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
from repro_torch.core import mc as tmc
from repro_torch.core import prng


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 + 5])
def test_key_split_fold_in_match_jax(seed):
    k = jax.random.key(seed)
    tk = prng.key(seed, "cpu")
    assert [int(x) for x in tk] == jax.random.key_data(k).tolist()
    got = [int(x) for pair in prng.split(tk) for x in pair]
    assert got == jax.random.key_data(jax.random.split(k)).ravel().tolist()
    data = torch.tensor([0, 1, 7, 2**31 + 3, 2**32 - 1])
    f0, f1 = prng.fold_in(tk, data)
    for i, d in enumerate(data.tolist()):
        want = jax.random.key_data(jax.random.fold_in(k, d)).tolist()
        assert [int(f0[i]), int(f1[i])] == want


@pytest.mark.parametrize("maxval", [1, 2, 3, 5, 17, 77, 65537, 100_000, 2**31 - 1])
def test_uniform_and_randint_match_jax(maxval):
    k = jax.random.fold_in(jax.random.key(3), maxval)
    tk = prng.fold_in(prng.key(3, "cpu"), maxval)
    u = prng.uniform(tk, 33).numpy()
    assert u.dtype == np.float32
    np.testing.assert_array_equal(u, np.asarray(jax.random.uniform(k, (33,))))
    r = prng.randint(tk, 33, 1, maxval).numpy()
    assert r.dtype == np.int32
    np.testing.assert_array_equal(r, np.asarray(jax.random.randint(k, (33,), 1, maxval)))


# (seed, theta, L, K): the tests/test_kernels.py mc sweep shapes, K=77, and
# a histogram-branch K
SERIAL = [
    (0, 512, 4, 2), (1, 1000, 8, 5), (2, 300, 12, 17),
    (3, 700, 12, 77), (4, 257, 6, 19), (5, 16, 3, 2),
]


@pytest.mark.parametrize("seed,theta,L,K", SERIAL)
def test_sample_pool_responses_bitwise(seed, theta, L, K):
    p = np.random.default_rng(seed).uniform(0.05, 0.99, L).astype(np.float32)
    want = np.asarray(jmc.sample_pool_responses(jax.random.key(seed), jnp.asarray(p), K, theta))
    got = tmc.sample_pool_responses(prng.key(seed, "cpu"), p, K, theta)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


# (seed, G, theta, L, K): the tests/test_kernels.py grouped sweep shapes + K=77
GROUPED = [
    (1, 1, 512, 4, 2), (2, 5, 700, 8, 5), (3, 3, 300, 12, 7), (4, 4, 600, 12, 77),
]


@pytest.mark.parametrize("seed,G,theta,L,K", GROUPED)
def test_sample_pool_responses_grouped_bitwise(seed, G, theta, L, K):
    ps = np.random.default_rng(seed).uniform(0.2, 0.95, (G, L)).astype(np.float32)
    want = np.asarray(
        jmc.sample_pool_responses_grouped(jax.random.key(seed), jnp.asarray(ps), K, theta)
    )
    got = tmc.sample_pool_responses_grouped(prng.key(seed, "cpu"), ps, K, theta)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("seed,G,theta,L,K", GROUPED)
def test_grouped_estimator_tables_bitwise(seed, G, theta, L, K):
    """The estimator's staged tables (draws masked past each group's theta,
    log weights, empty beliefs, thetas) equal the reference's."""
    rng = np.random.default_rng(seed)
    ps = rng.uniform(0.2, 0.95, (G, L))
    thetas = rng.integers(max(2, theta // 2), theta + 1, G)
    ref = jmc.GroupedXiEstimator(jax.random.key(seed), ps, K, thetas)
    est = tmc.GroupedXiEstimator(prng.key(seed, "cpu"), ps, K, thetas, device="cpu")
    np.testing.assert_array_equal(est.responses.numpy(), ref.responses)
    np.testing.assert_array_equal(est.responses_t.numpy(), ref.responses_t)
    np.testing.assert_array_equal(est.valid.numpy(), ref.valid)
    np.testing.assert_array_equal(est.log_weights.numpy(), ref.log_weights)
    np.testing.assert_array_equal(est.empty.numpy(), ref.empty)
    np.testing.assert_array_equal(est.theta_f.numpy(), ref.theta_f)


def test_draws_are_prefix_stable():
    """Row t depends only on (key, t): a longer draw extends a shorter one."""
    key = prng.key(11, "cpu")
    p = np.full(5, 0.6, np.float32)
    short = tmc.sample_pool_responses(key, p, 4, 37)
    long = tmc.sample_pool_responses(key, p, 4, 300)
    np.testing.assert_array_equal(long[:37].numpy(), short.numpy())
