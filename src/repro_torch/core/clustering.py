"""Embedding clustering for query-class discovery (Section 3.1).

Numpy; the PyTorch port's copy of the blocked K-means of
``repro/core/clustering.py`` (DBSCAN waits for a later slice).
"""
from __future__ import annotations

from typing import Tuple

import numpy as np


def _pairwise_sq_dists_blocked(x: np.ndarray, y: np.ndarray, block: int = 2048) -> np.ndarray:
    """(N, d) x (M, d) -> (N, M) squared distances, computed in row blocks."""
    n = x.shape[0]
    out = np.empty((n, y.shape[0]), np.float64)
    y_sq = (y * y).sum(axis=1)
    for s in range(0, n, block):
        e = min(s + block, n)
        xb = x[s:e]
        out[s:e] = (xb * xb).sum(axis=1)[:, None] - 2.0 * xb @ y.T + y_sq[None, :]
    return np.maximum(out, 0.0)


def kmeans(
    x: np.ndarray, k: int, iters: int = 50, seed: int = 0, tol: float = 1e-7
) -> Tuple[np.ndarray, np.ndarray]:
    """K-means++ init + Lloyd iterations. Returns (assignments (N,), centroids (k, d))."""
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    k = min(k, n)
    rng = np.random.default_rng(seed)

    # k-means++ seeding
    centroids = np.empty((k, x.shape[1]), np.float64)
    centroids[0] = x[rng.integers(n)]
    d2 = ((x - centroids[0]) ** 2).sum(axis=1)
    for j in range(1, k):
        probs = d2 / max(d2.sum(), 1e-30)
        centroids[j] = x[rng.choice(n, p=probs)]
        d2 = np.minimum(d2, ((x - centroids[j]) ** 2).sum(axis=1))

    assign = np.zeros(n, np.int64)
    for _ in range(iters):
        d = _pairwise_sq_dists_blocked(x, centroids)
        new_assign = d.argmin(axis=1)
        shift = 0.0
        for j in range(k):
            pts = x[new_assign == j]
            if pts.size:
                c = pts.mean(axis=0)
                shift += float(((c - centroids[j]) ** 2).sum())
                centroids[j] = c
        assign = new_assign
        if shift < tol:
            break
    return assign, centroids
