"""Correctness probability xi(S) (Def. 1) and the surrogate gamma(S) (Eq. 5).

Exact xi enumerates the observation space Omega_S (size K^|S|) with fully
vectorized numpy — used for tests, small ensembles, and as the oracle for the
Monte-Carlo estimator. Ground truth is fixed to class 0 WLOG (Prop. 1).

gamma(S) = 1 - prod_{l in S} (1 - p_l) is the submodular upper bound
(Lemma 3); its marginals are closed-form.
"""
from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from .belief import empty_log_belief, log_weight
from .types import clip_probs

# Enumeration budget: refuse exact computation beyond this many
# (observation x class) table entries; callers fall back to Monte Carlo.
EXACT_ENUM_CAP = 40_000_000


def gamma(p: np.ndarray) -> float:
    """Surrogate gamma(S) = 1 - prod(1 - p) over the arms in S."""
    p = np.asarray(p, np.float64)
    if p.size == 0:
        return 0.0
    return float(1.0 - np.prod(1.0 - p))


def gamma_marginal(p_new: float, p_chosen: np.ndarray) -> float:
    """gamma(S + l) - gamma(S) = p_l * prod_{S}(1 - p)."""
    return float(p_new * np.prod(1.0 - np.asarray(p_chosen, np.float64)))


def xi_exact_feasible(m: int, num_classes: int, cap: int = EXACT_ENUM_CAP) -> bool:
    if m == 0:
        return True
    return (num_classes ** m) * num_classes <= cap


def enumerate_observations(m: int, num_classes: int) -> np.ndarray:
    """All K^m observations as an (T, m) int array (mixed-radix counting)."""
    T = num_classes ** m
    obs = np.empty((T, m), np.int64)
    idx = np.arange(T)
    for j in range(m):
        obs[:, m - 1 - j] = (idx // (num_classes ** j)) % num_classes
    return obs


def xi_exact(
    p: np.ndarray,
    num_classes: int,
    p_all: Optional[np.ndarray] = None,
    tol: float = 1e-12,
    cap: int = EXACT_ENUM_CAP,
) -> float:
    """Exact correctness probability of the ensemble with success probs ``p``.

    Ties in the argmax-belief prediction are credited fractionally
    (random tie-breaking in expectation). ``p_all`` supplies the pool-wide
    probabilities for the empty-class belief heuristic; defaults to ``p``.
    """
    p = clip_probs(p)
    m = int(p.size)
    K = int(num_classes)
    if m == 0:
        return 1.0 / K
    if not xi_exact_feasible(m, K, cap):
        raise ValueError(
            f"exact xi infeasible for |S|={m}, K={K}; use the MC estimator"
        )
    w = log_weight(p, K)
    empty = empty_log_belief(p if p_all is None else p_all)

    obs = enumerate_observations(m, K)                       # (T, m)
    T = obs.shape[0]
    # Pr[obs | ground truth = 0]  (Eq. 1)
    correct = obs == 0                                       # (T, m)
    logp = np.where(correct, np.log(p)[None, :], np.log1p(-p)[None, :] - np.log(K - 1.0))
    prob = np.exp(logp.sum(axis=1))                          # (T,)

    # Beliefs: one-hot contraction (T, K)
    onehot = np.zeros((T, m, K), np.float64)
    rows = np.repeat(np.arange(T), m)
    cols = np.tile(np.arange(m), T)
    onehot[rows, cols, obs.ravel()] = 1.0
    beliefs = np.einsum("m,tmk->tk", w, onehot)
    counts = onehot.sum(axis=1)
    beliefs = np.where(counts > 0, beliefs, empty)

    mx = beliefs.max(axis=1, keepdims=True)
    is_max = beliefs >= mx - tol
    ties = is_max.sum(axis=1)
    credit = is_max[:, 0] / ties
    return float(np.sum(prob * credit))


def xi_pair(p1: float, p2: float) -> float:
    """Prop. 2: xi({l1, l2}) = max(p1, p2) (used as a test oracle)."""
    return float(max(p1, p2))


def xi_upper_bound_check(p: np.ndarray, num_classes: int) -> bool:
    """Lemma 3 sanity: gamma(S) >= xi(S)."""
    return gamma(p) >= xi_exact(p, num_classes) - 1e-12


def subset_probs(p: np.ndarray, idx: Sequence[int]) -> np.ndarray:
    return np.asarray(p, np.float64)[np.asarray(idx, np.int64)] if len(idx) else np.zeros(0)
