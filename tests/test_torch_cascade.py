"""The port's baselines and response aggregation against the JAX package:
``aggregate_predict`` (the Fig. 14 ablation's three methods) and the
selectors of ``core/cascade.py``. Both packages are numpy here, so every
comparison is exact, on the same seeded inputs and rng streams.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):      # removed in jax 0.9
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np
import pytest

from repro.core import belief as jbel
from repro.core import cascade as jcas
from repro_torch.core import (
    FrugalCascade,
    aggregate_predict,
    blender_all,
    random_subset,
    single_best,
    topk_weighted,
)


def _pool(seed, L=8):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.3, 0.95, L), rng.uniform(1e-6, 1e-4, L)


@pytest.mark.parametrize("method", ["ml", "weighted", "majority"])
@pytest.mark.parametrize("K", [2, 4, 77])
def test_aggregate_predict_matches_reference(method, K):
    rng = np.random.default_rng(K)
    for _ in range(60):
        m = int(rng.integers(1, 9))
        responses = rng.integers(0, min(K, 3), m)       # few classes: many ties
        probs = rng.uniform(0.3, 0.95, m)
        p_all = np.concatenate([probs, rng.uniform(0.2, 0.9, 3)])
        for kwargs in ({}, {"p_all": p_all}):
            seed = int(rng.integers(1 << 30))
            got = aggregate_predict(responses, probs, K, method=method,
                                    rng=np.random.default_rng(seed), **kwargs)
            want = jbel.aggregate_predict(responses, probs, K, method=method,
                                          rng=np.random.default_rng(seed), **kwargs)
            assert got == want
            assert (aggregate_predict(responses, probs, K, method=method, **kwargs)
                    == jbel.aggregate_predict(responses, probs, K, method=method, **kwargs))


@pytest.mark.parametrize("with_rng", [False, True])
def test_aggregate_predict_without_responses(with_rng):
    for K in (2, 5, 77):
        a = np.random.default_rng(K) if with_rng else None
        b = np.random.default_rng(K) if with_rng else None
        assert (aggregate_predict(np.zeros(0, np.int64), np.zeros(0), K, rng=a)
                == jbel.aggregate_predict(np.zeros(0, np.int64), np.zeros(0), K, rng=b))


def test_aggregate_predict_rejects_unknown_method():
    with pytest.raises(ValueError, match="unknown aggregation method"):
        aggregate_predict(np.array([0]), np.array([0.8]), 3, method="vote")


def _oracle(seed, p, K):
    """An invoke_fn answering class 0 w.p. p_arm, else a wrong class."""
    rng = np.random.default_rng(seed)

    def invoke(arm):
        return 0 if rng.random() < p[arm] else int(rng.integers(1, K))
    return invoke


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("margin", [0.5, 1.0, 2.0, 50.0])
def test_frugal_cascade_matches_reference(strict, margin):
    for seed in range(6):
        p, b = _pool(seed)
        K = 3 + seed
        for budget in (0.0, 2e-5, 1e-4, 1e-3):
            got = FrugalCascade(b, margin=margin, strict=strict).answer(
                p, K, budget, _oracle(seed, p, K), rng=np.random.default_rng(seed))
            want = jcas.FrugalCascade(b, margin=margin, strict=strict).answer(
                p, K, budget, _oracle(seed, p, K), rng=np.random.default_rng(seed))
            assert got.prediction == want.prediction
            np.testing.assert_array_equal(got.used, want.used)
            np.testing.assert_array_equal(got.responses, want.responses)
            np.testing.assert_array_equal(got.log_beliefs, want.log_beliefs)
            assert (got.cost, got.planned_cost) == (want.cost, want.planned_cost)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_blender_all_matches_reference(seed):
    p, b = _pool(seed)
    for K in (2, 4):
        got = blender_all(p, K, _oracle(seed, p, K), b, rng=np.random.default_rng(seed))
        want = jcas.blender_all(p, K, _oracle(seed, p, K), b, rng=np.random.default_rng(seed))
        assert got.prediction == want.prediction
        np.testing.assert_array_equal(got.used, want.used)
        np.testing.assert_array_equal(got.responses, want.responses)
        assert (got.cost, got.planned_cost) == (want.cost, want.planned_cost)


@pytest.mark.parametrize("name", ["topk_weighted", "single_best", "random_subset"])
def test_subset_baselines_match_reference(name):
    port = {"topk_weighted": topk_weighted, "single_best": single_best,
            "random_subset": random_subset}[name]
    ref = getattr(jcas, name)
    for seed in range(8):
        p, b = _pool(seed, L=4 + seed)
        # 0.0 affords nothing: single_best then returns the empty set
        for budget in (0.0, float(b.min()), 5e-5, 2e-4, 1.0):
            if name == "random_subset":
                got = port(b, budget, np.random.default_rng(seed))
                want = ref(b, budget, np.random.default_rng(seed))
            else:
                got, want = port(p, b, budget), ref(p, b, budget)
            assert got.dtype == want.dtype
            np.testing.assert_array_equal(got, want)
            assert float(b[got].sum()) <= budget + 1e-15
    assert single_best(p, b, 0.0).size == 0
