"""Embedding clustering for query-class discovery (Section 3.1).

Numpy; the PyTorch port's copy of ``repro/core/clustering.py``: blocked
K-means, DBSCAN and its eps heuristic.
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


def dbscan(x: np.ndarray, eps: float, min_pts: int = 4, block: int = 2048) -> np.ndarray:
    """DBSCAN over euclidean distance; noise labelled -1.

    Blocked neighbor computation keeps peak memory at O(block * N).
    """
    x = np.asarray(x, np.float64)
    n = x.shape[0]
    eps_sq = eps * eps
    labels = np.full(n, -2, np.int64)  # -2 unvisited, -1 noise
    # Precompute neighbor lists blockwise.
    neighbors = [None] * n
    for s in range(0, n, block):
        e = min(s + block, n)
        d = _pairwise_sq_dists_blocked(x[s:e], x)
        for i in range(s, e):
            neighbors[i] = np.flatnonzero(d[i - s] <= eps_sq)

    cid = 0
    for i in range(n):
        if labels[i] != -2:
            continue
        if neighbors[i].size < min_pts:
            labels[i] = -1
            continue
        labels[i] = cid
        frontier = list(neighbors[i])
        while frontier:
            j = frontier.pop()
            if labels[j] == -1:
                labels[j] = cid
            if labels[j] != -2:
                continue
            labels[j] = cid
            if neighbors[j].size >= min_pts:
                frontier.extend(neighbors[j])
        cid += 1
    return labels


def auto_eps(x: np.ndarray, q: float = 0.15, sample: int = 1024, seed: int = 0) -> float:
    """Heuristic eps: q-quantile of pairwise distances on a subsample."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    idx = rng.choice(n, size=min(sample, n), replace=False)
    d = np.sqrt(_pairwise_sq_dists_blocked(x[idx], x[idx]))
    vals = d[np.triu_indices_from(d, k=1)]
    return float(np.quantile(vals, q)) if vals.size else 1.0
