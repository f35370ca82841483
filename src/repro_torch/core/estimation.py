"""Success-probability estimation from historical data (Section 3.1 + 4.4).

Numpy; the PyTorch port's copy of ``repro/core/estimation.py``.

Pipeline: embed historical queries -> cluster (K-means / DBSCAN) -> per-cluster
per-arm accuracy means p-hat with confidence intervals (Hoeffding / Wilson)
-> optional median-boosting of the interval failure probability (Lemma 5)
-> at query time, map a test embedding to the nearest cluster and read its
p-hat vector.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np

from .types import QueryClass


# ---------------------------------------------------------------------------
# Confidence intervals
# ---------------------------------------------------------------------------


def hoeffding_interval(p_hat: np.ndarray, n, delta: float) -> Tuple[np.ndarray, np.ndarray]:
    """Two-sided Hoeffding CI at confidence 1 - delta.

    ``n`` may be a scalar or an array of per-arm observation counts (online
    feedback observes arms unevenly — see ``SuccessProbEstimator.update_counts``);
    entries with ``n <= 0`` get the vacuous [0, 1] interval.
    """
    n = np.asarray(n, np.float64)
    if n.ndim == 0 and n <= 0:
        return np.zeros_like(p_hat), np.ones_like(p_hat)
    half = np.sqrt(math.log(2.0 / delta) / (2.0 * np.maximum(n, 1.0)))
    lo = np.clip(p_hat - half, 0.0, 1.0)
    hi = np.clip(p_hat + half, 0.0, 1.0)
    return np.where(n > 0, lo, 0.0), np.where(n > 0, hi, 1.0)


def wilson_interval(p_hat: np.ndarray, n, delta: float) -> Tuple[np.ndarray, np.ndarray]:
    """Wilson score interval — tighter than Hoeffding at small n.

    Accepts scalar or per-arm array ``n`` like :func:`hoeffding_interval`;
    the serving drift detector (``serving/feedback.py``) relies on the
    per-arm form to compare old-vs-new estimates at their own counts.
    """
    n = np.asarray(n, np.float64)
    if n.ndim == 0 and n <= 0:
        return np.zeros_like(p_hat), np.ones_like(p_hat)
    # two-sided normal quantile via inverse erf
    from scipy.special import erfinv

    z = math.sqrt(2.0) * float(erfinv(1.0 - delta))
    safe = np.maximum(n, 1.0)
    denom = 1.0 + z * z / safe
    center = (p_hat + z * z / (2 * safe)) / denom
    half = z * np.sqrt(p_hat * (1 - p_hat) / safe + z * z / (4 * safe * safe)) / denom
    lo = np.clip(center - half, 0.0, 1.0)
    hi = np.clip(center + half, 0.0, 1.0)
    return np.where(n > 0, lo, 0.0), np.where(n > 0, hi, 1.0)


def median_boost_rounds(num_arms: int, delta: float, delta_l: float) -> int:
    """Lemma 5 repetition count: Lambda_l = 6 log(L/delta) / (1-2 delta_l)^2."""
    if delta_l >= 0.5:
        raise ValueError("median boosting needs delta_l < 1/2")
    return max(1, int(math.ceil(6.0 * math.log(num_arms / delta) / (1.0 - 2.0 * delta_l) ** 2)))


def median_boosted_interval(
    table: np.ndarray,            # (n, L) boolean outcomes for one cluster
    delta: float,
    delta_l: float = 0.25,
    subsample_frac: float = 0.5,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Median-of-repetitions interval (Lemma 5).

    Repeats the base estimator Lambda times on bootstrap subsamples and takes
    the interval whose center is the median estimate, driving the failure
    probability down to exp(-Lambda (1-2 delta_l)^2 / 2).

    Returns (p_hat, lo, hi), each (L,).
    """
    n, L = table.shape
    rounds = median_boost_rounds(L, delta, delta_l)
    rng = np.random.default_rng(seed)
    sub_n = max(1, int(n * subsample_frac))
    ests = np.empty((rounds, L))
    los = np.empty((rounds, L))
    his = np.empty((rounds, L))
    for r in range(rounds):
        idx = rng.choice(n, size=sub_n, replace=True)
        p_hat = table[idx].mean(axis=0)
        lo, hi = hoeffding_interval(p_hat, sub_n, delta_l)
        ests[r], los[r], his[r] = p_hat, lo, hi
    med = np.argsort(ests, axis=0)[rounds // 2]
    cols = np.arange(L)
    return ests[med, cols], los[med, cols], his[med, cols]


def fold_counts(
    p_hat: np.ndarray,
    counts: np.ndarray,
    successes: np.ndarray,
    attempts: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray]:
    """Exact streaming fold of per-arm (successes, attempts) feedback into a
    (p_hat, counts) estimate; arms with zero attempts keep their estimate.

    The single fold authority: :meth:`SuccessProbEstimator.update_counts`
    commits with it and the serving drift detector
    (``serving/feedback.py``) pre-computes its candidate with it, so the
    drift decision can never diverge from what actually folds in.
    Returns ``(new_p_hat, new_counts)``.
    """
    new_counts = counts + attempts
    new_p = np.where(
        attempts > 0,
        (p_hat * counts + successes) / np.maximum(new_counts, 1.0),
        p_hat,
    )
    return new_p, new_counts


# ---------------------------------------------------------------------------
# Historical-table estimation
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class ClusterStats:
    """Per-cluster success-probability estimates over the pool.

    Besides the estimate itself, a cluster carries the state the online
    feedback loop needs: per-arm observation counts (served traffic observes
    arms unevenly — only invoked waves yield feedback), the estimator
    ``version`` of the last *plan-visible* change, and a snapshot of the
    estimate at that version. Plan caches key on ``version``; the drift
    detector compares fresh feedback against the snapshot, so feedback that
    merely confirms the current estimate never invalidates a plan.
    """

    centroid: np.ndarray          # (d,) embedding centroid
    p_hat: np.ndarray             # (L,)
    lo: np.ndarray                # (L,)
    hi: np.ndarray                # (L,)
    count: int
    arm_counts: Optional[np.ndarray] = None   # (L,) per-arm observations
    version: int = 0              # estimator version of last plan-visible change
    plan_p_hat: Optional[np.ndarray] = None   # estimate snapshot at `version`
    plan_arm_counts: Optional[np.ndarray] = None

    def __post_init__(self):
        if self.arm_counts is None:
            self.arm_counts = np.full(self.p_hat.shape, float(self.count))
        if self.plan_p_hat is None:
            self.plan_p_hat = self.p_hat
        if self.plan_arm_counts is None:
            self.plan_arm_counts = self.arm_counts


class SuccessProbEstimator:
    """Section 3.1 estimator: cluster historical queries, average accuracy.

    Args:
      table: (N, L) boolean historical response-correctness matrix T.
      embeddings: (N, d) query embeddings.
      cluster_ids: (N,) precomputed cluster assignment (from
        ``core/clustering.py``).
      delta: per-arm interval failure probability target.
      boost: apply Lemma-5 median boosting to the intervals.
    """

    def __init__(
        self,
        table: np.ndarray,
        embeddings: np.ndarray,
        cluster_ids: np.ndarray,
        delta: float = 0.01,
        boost: bool = False,
        min_cluster_size: int = 3,
    ):
        table = np.asarray(table, np.float64)
        embeddings = np.asarray(embeddings, np.float64)
        cluster_ids = np.asarray(cluster_ids, np.int64)
        self.num_arms = table.shape[1]
        self.clusters: Dict[int, ClusterStats] = {}
        self._global_p = table.mean(axis=0)
        # version: strictly monotone, bumped by every feedback fold.
        # plan_version: the version of the last *plan-visible* change — the
        # coarse key the PlanService's batch tables invalidate on (confirming
        # feedback bumps `version` but leaves `plan_version` put).
        self.version = 0
        self.plan_version = 0

        for cid in np.unique(cluster_ids):
            if cid < 0:  # DBSCAN noise: folded into the global estimate
                continue
            idx = np.flatnonzero(cluster_ids == cid)
            if idx.size < min_cluster_size:
                continue
            sub = table[idx]
            if boost:
                p_hat, lo, hi = median_boosted_interval(sub, delta)
            else:
                p_hat = sub.mean(axis=0)
                lo, hi = hoeffding_interval(p_hat, idx.size, delta)
            self.clusters[int(cid)] = ClusterStats(
                centroid=embeddings[idx].mean(axis=0),
                p_hat=p_hat,
                lo=lo,
                hi=hi,
                count=int(idx.size),
            )
        if not self.clusters:  # degenerate: one global cluster
            lo, hi = hoeffding_interval(self._global_p, table.shape[0], delta)
            self.clusters[0] = ClusterStats(
                centroid=embeddings.mean(axis=0),
                p_hat=self._global_p,
                lo=lo,
                hi=hi,
                count=table.shape[0],
            )
        self._centroids = np.stack([c.centroid for c in self.clusters.values()])
        self._cids = np.asarray(list(self.clusters.keys()))
        self._centroid_sq = (self._centroids ** 2).sum(axis=1)

    def lookup(self, embedding: np.ndarray) -> ClusterStats:
        """Nearest-centroid mapping of a test query to a historical cluster
        (the paper's semantic-similarity mapping, App. B). Delegates to
        :meth:`lookup_batch` so single and batched lookups always agree."""
        return self.clusters[int(self.lookup_batch(embedding[None, :])[0])]

    @property
    def cluster_order(self) -> np.ndarray:
        """(C,) cluster ids in dense-index order — the alignment contract
        for :meth:`lookup_batch_indices` and the PlanService batch tables."""
        return self._cids

    def lookup_batch_indices(self, embeddings: np.ndarray) -> np.ndarray:
        """(B, d) -> (B,) dense indices into :attr:`cluster_order`.

        The serving fast path: a dense index doubles as the gather index
        into precomputed per-cluster wave tables, so routing a batch never
        needs an ``np.unique`` pass over its cluster ids."""
        e = np.asarray(embeddings, np.float64)
        d = self._centroid_sq[None, :] - 2.0 * (e @ self._centroids.T)
        return np.argmin(d, axis=1)

    def lookup_batch(self, embeddings: np.ndarray) -> np.ndarray:
        """(B, d) -> (B,) cluster ids (matmul distance, no (B, C, d) temp)."""
        return self._cids[self.lookup_batch_indices(embeddings)]

    def update(
        self, cluster_id: int, outcomes: np.ndarray, delta: float = 0.01
    ) -> ClusterStats:
        """Online recalibration: fold a batch of observed per-arm correctness
        outcomes (n, L) into the cluster's running estimate — the production
        analogue of the paper's growing historical table. Counts accumulate
        exactly (streaming mean) and the CI tightens with n. Delegates to
        :meth:`update_counts` with every arm observed n times; a direct call
        is always plan-visible (cached plans for this cluster invalidate)."""
        outcomes = np.atleast_2d(np.asarray(outcomes, np.float64))
        n_new = outcomes.shape[0]
        return self.update_counts(
            cluster_id,
            outcomes.sum(axis=0),
            np.full(outcomes.shape[1], float(n_new)),
            queries=n_new,
            delta=delta,
        )

    def update_counts(
        self,
        cluster_id: int,
        successes: np.ndarray,
        attempts: np.ndarray,
        queries: int = 0,
        delta: float = 0.01,
        plan_visible: bool = True,
    ) -> ClusterStats:
        """Vectorized per-(cluster, arm) feedback fold — the online loop's
        entry point (Sec. 3.1's growing table, fed from served traffic).

        Args:
          successes/attempts: (L,) per-arm correct counts and observation
            counts. ``attempts[l]`` may be 0 for arms the serving plans never
            invoked — those arms keep their current estimate and interval.
          queries: labeled queries this fold represents (bookkeeping only).
          plan_visible: bump the cluster's plan ``version`` (and the
            estimator's ``plan_version``) and re-snapshot the estimate. The
            drift detector passes ``False`` for feedback that confirms the
            current estimate, so plan caches keep serving.

        Counts accumulate exactly, so folding the same feedback in any batch
        order yields the same estimate (up to float rounding), and the
        estimator ``version`` is strictly monotone under any interleaving.
        """
        st = self.clusters[int(cluster_id)]
        successes = np.asarray(successes, np.float64)
        attempts = np.asarray(attempts, np.float64)
        st.p_hat, st.arm_counts = fold_counts(
            st.p_hat, st.arm_counts, successes, attempts
        )
        st.count = int(st.count + queries)
        st.lo, st.hi = hoeffding_interval(st.p_hat, st.arm_counts, delta)
        self.version += 1
        if plan_visible:
            st.version = self.version
            st.plan_p_hat = st.p_hat
            st.plan_arm_counts = st.arm_counts
            self.plan_version = self.version
        return st

    def touch(self, cluster_id: Optional[int] = None) -> int:
        """Mark estimates as changed out-of-band.

        The serving plan caches key on estimator *versions*, which only
        :meth:`update` / :meth:`update_counts` bump — a direct assignment
        to ``clusters[c].p_hat`` is invisible to them and would keep stale
        plans serving. Call this afterwards (one cluster, or all with
        ``None``) to bump the version(s) and re-snapshot, making the
        change plan-visible. Returns the new estimator version."""
        cids = list(self.clusters) if cluster_id is None else [int(cluster_id)]
        for cid in cids:
            st = self.clusters[cid]
            self.version += 1
            st.version = self.version
            st.plan_p_hat = st.p_hat
            st.plan_arm_counts = st.arm_counts
        self.plan_version = self.version
        return self.version

    def query_class(
        self, embedding: np.ndarray, num_classes: int, alpha: Optional[float] = None
    ) -> QueryClass:
        """Build a QueryClass for a test query; ``alpha`` optionally overrides
        the interval width (the Table 6 ablation: lo = p - a/2, hi = p + a/2)."""
        st = self.lookup(embedding)
        if alpha is not None:
            lo = np.clip(st.p_hat - alpha / 2, 0.0, 1.0)
            hi = np.clip(st.p_hat + alpha / 2, 0.0, 1.0)
        else:
            lo, hi = st.lo, st.hi
        return QueryClass(
            probs=st.p_hat, num_classes=num_classes, lo=lo, hi=hi,
            meta={"count": st.count},
        )
