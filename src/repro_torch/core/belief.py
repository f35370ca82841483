"""Response aggregation by maximum likelihood (paper Section 3.2).

Given responses R(l) of an ensemble S on a K-class query, the belief of
class C_k is (Eq. 4):

    h(C_k | phi) = prod_{l in S(C_k)} p_l (K-1) / (1 - p_l)

and the aggregated prediction is argmax_k h (Fact 1). We work in log space:
``log_weight(p) = log(p) + log(K-1) - log(1-p)`` and beliefs are sums of the
weights of the arms that voted for each class. Classes with no votes receive
the paper's heuristic belief ``p_min / (2 (1 - p_min))``.

The numpy helpers are the control plane and are copied from
``repro/core/belief.py``; the batched data-plane path
(:func:`aggregate_log_beliefs_batch`, :func:`predict_batch`) runs on torch
tensors on whatever device they live on.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .types import P_FLOOR, clip_probs

# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------


def log_weight(p: np.ndarray, num_classes: int, floor: float = P_FLOOR) -> np.ndarray:
    """log of p(K-1)/(1-p), the per-arm multiplicative belief weight."""
    p = clip_probs(p, floor)
    return np.log(p) + np.log(num_classes - 1.0) - np.log1p(-p)


def empty_log_belief(p_all: np.ndarray, floor: float = P_FLOOR) -> float:
    """Paper heuristic for classes with no votes: p_min / (2 (1 - p_min))."""
    p_min = float(np.min(clip_probs(p_all, floor)))
    return float(np.log(p_min) - np.log(2.0) - np.log1p(-p_min))


# ---------------------------------------------------------------------------
# Aggregation: numpy control-plane path
# ---------------------------------------------------------------------------


def aggregate_log_beliefs(
    responses: np.ndarray,
    weights: np.ndarray,
    num_classes: int,
    empty_belief: float,
) -> np.ndarray:
    """(m,) responses + (m,) log-weights -> (K,) log-beliefs.

    Empty classes (no votes) get ``empty_belief``.
    """
    responses = np.asarray(responses, np.int64)
    beliefs = np.zeros(num_classes, np.float64)
    counts = np.zeros(num_classes, np.int64)
    np.add.at(beliefs, responses, np.asarray(weights, np.float64))
    np.add.at(counts, responses, 1)
    beliefs[counts == 0] = empty_belief
    return beliefs


def tie_break_argmax(
    beliefs: np.ndarray, rng: Optional[np.random.Generator] = None, tol: float = 1e-9
) -> Tuple[np.ndarray, np.ndarray]:
    """argmax over the last axis with uniform tie-breaking within ``tol``.

    The single tie-break rule shared by the per-query path
    (:func:`repro_torch.core.selection.adaptive_invoke`) and the batched
    serving router, so both finalize identically. Accepts (K,) or (B, K)
    beliefs and returns (predictions, n_ties) of matching leading shape.

    With ``rng=None`` the break is deterministic first-max (plain argmax);
    with an rng, a tied class is drawn uniformly. The rng is only consumed
    when at least one row actually has a tie, so tie-free batches stay
    bitwise reproducible across both paths.
    """
    b = np.atleast_2d(np.asarray(beliefs, np.float64))
    mx = b.max(axis=-1, keepdims=True)
    ties = b >= mx - tol
    n_ties = ties.sum(axis=-1)
    if rng is None or not np.any(n_ties > 1):
        pred = np.argmax(b, axis=-1)
    else:
        pred = np.argmax(np.where(ties, rng.random(b.shape), -1.0), axis=-1)
    pred = pred.astype(np.int64)
    if np.asarray(beliefs).ndim == 1:
        return pred[0], n_ties[0]
    return pred, n_ties


def predict_from_beliefs(
    beliefs: np.ndarray, rng: Optional[np.random.Generator] = None, tol: float = 1e-9
) -> Tuple[int, int]:
    """argmax with random tie-break for one (K,) belief vector;
    returns (class, n_ties). Delegates to :func:`tie_break_argmax`."""
    pred, n_ties = tie_break_argmax(np.asarray(beliefs, np.float64), rng, tol)
    return int(pred), int(n_ties)


def aggregate_predict(
    responses: np.ndarray,
    probs: np.ndarray,
    num_classes: int,
    method: str = "ml",
    rng: Optional[np.random.Generator] = None,
    p_all: Optional[np.ndarray] = None,
) -> int:
    """Full aggregation pipeline for one query.

    Args:
      responses: (m,) class ids predicted by the invoked arms.
      probs: (m,) success probabilities of those arms on this query class.
      method: ``"ml"`` (paper, Eq. 4) | ``"weighted"`` (sum of p as vote
        weight) | ``"majority"`` (unweighted) -- the Fig. 14 ablation.
      p_all: pool-wide probs for the empty-class heuristic (defaults to
        ``probs``).
    """
    if len(responses) == 0:
        return int(rng.integers(num_classes)) if rng is not None else 0
    probs = np.asarray(probs, np.float64)
    if method == "ml":
        w = log_weight(probs, num_classes)
        empty = empty_log_belief(probs if p_all is None else p_all)
    elif method == "weighted":
        w = probs
        empty = 0.0
    elif method == "majority":
        w = np.ones_like(probs)
        empty = 0.0
    else:
        raise ValueError(f"unknown aggregation method: {method}")
    beliefs = aggregate_log_beliefs(responses, w, num_classes, empty)
    pred, _ = predict_from_beliefs(beliefs, rng)
    return pred


def top2_beliefs(beliefs: np.ndarray) -> Tuple[float, float, int]:
    """Return (H1, H2, argmax) of a (K,) log-belief vector (Algorithm 3)."""
    order = np.argsort(beliefs)
    h1 = float(beliefs[order[-1]])
    h2 = float(beliefs[order[-2]]) if len(beliefs) > 1 else -np.inf
    return h1, h2, int(order[-1])


# ---------------------------------------------------------------------------
# Aggregation: torch batched data-plane path
# ---------------------------------------------------------------------------


def aggregate_log_beliefs_batch(
    responses: torch.Tensor,      # (B, m) int class ids; -1 = arm not invoked
    log_weights: torch.Tensor,    # (m,) or (B, m) float32
    num_classes: int,
    empty_belief,                 # scalar or (B,)
) -> torch.Tensor:
    """Batched belief aggregation: (B, K) float32 log-beliefs.

    Arms flagged ``-1`` contribute nothing. Votes are added one arm at a
    time in ascending ``m`` order, so every class's f32 sum has a fixed
    operand sequence (the order the ``belief_aggregate`` kernel adds in).
    """
    responses = responses.to(torch.int64)
    B, M = responses.shape
    w = torch.as_tensor(log_weights, dtype=torch.float32, device=responses.device)
    w = w.expand(B, M)
    classes = torch.arange(num_classes, device=responses.device)
    onehot = responses[:, :, None] == classes                        # (B, m, K)
    beliefs = torch.zeros(B, num_classes, dtype=torch.float32, device=responses.device)
    voted = torch.zeros(B, num_classes, dtype=torch.bool, device=responses.device)
    for m in range(M):
        hit = onehot[:, m]
        beliefs = torch.where(hit, beliefs + w[:, m:m + 1], beliefs)
        voted = voted | hit
    empty = torch.as_tensor(empty_belief, dtype=torch.float32, device=responses.device)
    empty = empty.expand(B)
    return torch.where(voted, beliefs, empty[:, None])


def predict_batch(
    responses: torch.Tensor,
    log_weights: torch.Tensor,
    num_classes: int,
    empty_belief,
) -> torch.Tensor:
    """Batched argmax-belief prediction; deterministic first-index tie-break."""
    beliefs = aggregate_log_beliefs_batch(responses, log_weights, num_classes, empty_belief)
    return torch.argmax(beliefs, dim=-1).to(torch.int32)
