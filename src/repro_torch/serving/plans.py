"""Plan-cache selection service: "plan once, route many" (host numpy; the
PyTorch port's copy of ``repro/serving/plans.py``, without the compile
cache, which has no counterpart in an eagerly run port).

Selection (SurGreedyLLM) is by far the most expensive step of routing a
query class — a Monte-Carlo greedy over the pool — yet its output depends
only on (cluster p-vector, num_classes, budget, pool costs). The
:class:`PlanService` therefore memoizes the fully derived *wave plan* of
each (cluster, budget) pair: the selected arms in invocation order, their
log belief weights, the Prop. 4 residuals, per-wave costs and the
empty-class belief. The router's hot path then reduces to a dictionary
lookup plus array gathers; this is the same structure OptLLM's
query-to-model assignment and FrugalGPT's offline-learned cascade policy
use to make cost-aware routing cheap per query.

Consistency is guarded by *versioned keys*: every plan key carries the
engine cost-vector digest plus its own cluster's plan ``version`` (the
estimator version of the cluster's last plan-visible change), and batch
tables key on the estimator's global ``plan_version``. Stale entries
therefore invalidate **lazily** — a re-estimated cluster's old plans can
never serve again because no lookup ever constructs their key — and
:meth:`PlanService.refresh` (called by the router once per batch) is
reduced to a cheap version/cost compare: on an estimate change it only
counts the invalidation and prunes the dead entries; on a cost change it
drops everything and re-snapshots the new cost vector into the selector.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.belief import empty_log_belief, log_weight
from repro_torch.core.types import clip_probs


@dataclasses.dataclass
class BatchTables:
    """Per-cluster wave plans stacked into gather-ready wave-major tables.

    One instance covers *every* cluster the estimator knows, at one budget,
    aligned with ``estimator.cluster_order`` — so routing a batch is a pure
    dense gather ``tables.order[:, idx]`` with no uniques, no Python loop.

    Attributes:
      order: (T, C) arm id invoked at wave t for cluster-column c, -1 pad.
      floats: (3, T, C) stacked [log-weights, Prop. 4 residuals, wave costs]
        so one fancy-index gathers all three per batch.
      empty: (C,) empty-class log beliefs.
      planned: (C,) full selected-set USD.
      cluster_ids: (C,) cluster ids aligned with the columns.
    """

    order: np.ndarray
    floats: np.ndarray
    empty: np.ndarray
    planned: np.ndarray
    cluster_ids: np.ndarray


def stack_plans(plans: Sequence["GroupPlan"]):
    """Stack :class:`GroupPlan`s into padded wave-major tables.

    The single layout authority for both the uniform-budget
    :class:`BatchTables` and the router's heterogeneous-budget group merge.
    Returns ``(order (T, G), floats (3, T, G) [weights, residual, costs],
    empty (G,), planned (G,))`` with -1 / -inf / 0 padding past each plan's
    length."""
    G = len(plans)
    T = max(1, max(p.order.size for p in plans))
    order = np.full((T, G), -1, np.int64)
    floats = np.zeros((3, T, G), np.float64)
    floats[1] = -np.inf
    empty = np.empty(G, np.float64)
    planned = np.empty(G, np.float64)
    for g, plan in enumerate(plans):
        n = plan.order.size
        order[:n, g] = plan.order
        floats[0, :n, g] = plan.weights
        floats[1, :n, g] = plan.residual
        floats[2, :n, g] = plan.wave_costs
        empty[g] = plan.empty
        planned[g] = plan.planned
    return order, floats, empty, planned


@dataclasses.dataclass
class GroupPlan:
    """Fully derived wave plan of one (cluster p-vector, budget) group.

    A plan is everything the wavefront loop needs to route a query of this
    group without consulting the selector again:

    Attributes:
      order: (n,) arm ids in decreasing-p invocation order (wave t invokes
        ``order[t]``).
      weights: (n,) log belief weight of ``order[t]`` (Eq. 4 in log space).
      residual: (n,) log F of the arms still ahead at wave t, i.e.
        ``sum(weights[t:])`` — the Prop. 4 early-stop potential.
      wave_costs: (n,) USD cost of ``order[t]``.
      empty: empty-class log belief (the paper's no-vote heuristic).
      planned: total USD of the selected set (the cost if no query of the
        group early-stops).
    """

    order: np.ndarray
    weights: np.ndarray
    residual: np.ndarray
    wave_costs: np.ndarray
    empty: float
    planned: float


# (cluster id, budget, own-cluster plan version, cost fingerprint) -> plan
PlanKey = Tuple[int, float, int, bytes]


class PlanService:
    """Memoizes :class:`GroupPlan`s keyed by (cluster, budget, pool fingerprint).

    Owned by a :class:`~repro_torch.serving.router.ThriftRouter`; shared across
    batches (and shareable across routers bound to the same pool). All
    methods are cheap except a miss, which runs SurGreedy selection.

    Misses of several pairs are **batched**: :meth:`plan_many` (and through
    it :meth:`batch_tables`) funnels its missing (cluster, budget) pairs into
    one :meth:`~repro_torch.core.selection.ThriftLLM.select_many` call, so a
    cold batch table costs one batched-planner call instead of a serial
    selection per pair; a single miss takes the serial planner. Both give
    bit-identical plans under the planner's shared-CRN contract.

    The reference's scheduler-facing entry points (``prewarm``,
    ``prefetch_for``, ``replan_stale``, ``hot_pairs``, ``known_budgets``) and
    its ``batched=False`` benchmark baseline wait for the scheduler slice.
    """

    def __init__(self, selector, estimator, engine, num_classes: int):
        self.selector = selector
        self.estimator = estimator
        self.engine = engine
        self.num_classes = int(num_classes)
        self._cache: Dict[PlanKey, GroupPlan] = {}
        self._table_cache: Dict[Tuple[float, bytes, int], BatchTables] = {}
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.stale_dropped = 0
        self._cost_fp = self.engine.fingerprint()
        self._plan_version = self._estimator_version()

    # ------------------------------------------------------------------
    # Pool identity
    # ------------------------------------------------------------------
    def _estimator_version(self) -> int:
        """The estimator's global plan version — bumped whenever any
        cluster's estimate changes in a plan-visible way (an ``update``
        or ``touch`` call). Batch-table keys carry it; per-pair plan keys
        carry the finer per-cluster version. NOTE: assigning ``p_hat``
        directly bypasses the version machinery — follow such edits with
        ``estimator.touch(cid)`` or the caches cannot see them."""
        return int(getattr(self.estimator, "plan_version", 0))

    def _cluster_version(self, cid: int) -> int:
        st = self.estimator.clusters.get(int(cid))
        return int(st.version) if st is not None else -1

    def refresh(self) -> bool:
        """Re-check the pool identity; returns True if anything invalidated.

        Invalidation is **lazy** for estimate changes: plan and table keys
        carry estimator versions, so a stale entry can never serve even if
        refresh is never called — this method just counts the invalidation
        and prunes the dead entries so the cache doesn't grow unboundedly.
        A *cost* change (re-priced or swapped arms) is handled eagerly
        because the selector's internal cost snapshot must be re-pulled
        from the engine before the next build.
        """
        cost_fp = self.engine.fingerprint()
        plan_version = self._estimator_version()
        if cost_fp == self._cost_fp and plan_version == self._plan_version:
            return False
        if cost_fp != self._cost_fp:
            self._cache.clear()
            self._table_cache.clear()
            self.selector.rebind_costs(self.engine.costs)
            self._cost_fp = cost_fp
        else:
            self._prune_stale()
        self._plan_version = plan_version
        self.invalidations += 1
        return True

    def _prune_stale(self) -> int:
        """Drop cache entries whose version/cost key no longer matches the
        live pool (they can never be looked up again). Returns plans
        dropped; accumulated in ``stale_dropped``."""
        live = [k for k in self._cache if k == self._plan_key(k[0], k[1])]
        dropped = len(self._cache) - len(live)
        if dropped:
            self._cache = {k: self._cache[k] for k in live}
        version = self._estimator_version()
        self._table_cache = {
            k: v for k, v in self._table_cache.items()
            if k[1] == self._cost_fp and k[2] == version
        }
        # the selector memoizes on p-vector bytes: entries for dead
        # estimates can never hit again, so bound them too or repeated
        # re-estimation grows the memo forever (oldest-first, live plans stay)
        self.selector.trim_cache(max(128, 4 * len(self._cache)))
        self.stale_dropped += dropped
        return dropped

    # ------------------------------------------------------------------
    # Planning
    # ------------------------------------------------------------------
    def _plan_key(self, cid: int, budget: float) -> PlanKey:
        # the cluster's live plan version is read at every lookup, so a
        # version bump makes old entries unreachable without any scan
        return (int(cid), float(budget), self._cluster_version(cid),
                self._cost_fp)

    def plan(self, cid: int, budget: float) -> GroupPlan:
        """Return the wave plan for (cluster ``cid``, ``budget``), building
        and caching it on first use."""
        key = self._plan_key(cid, budget)
        plan = self._cache.get(key)
        if plan is not None:
            self.hits += 1
            return plan
        self.misses += 1
        plan = self._build_many([(int(cid), float(budget))])[0]
        self._cache[key] = plan
        return plan

    def plan_many(self, pairs: Iterable[Tuple[int, float]]) -> List[GroupPlan]:
        """Wave plans for many (cluster, budget) pairs; one batched
        selection call covers every miss.

        The multi-pair mirror of :meth:`plan` (same hit/miss accounting,
        same cache): cached pairs gather for free, the missing ones are
        selected together through the batched planner. Returns plans
        aligned with ``pairs``.
        """
        pairs = [(int(c), float(bg)) for c, bg in pairs]
        missing = [
            pr for pr in dict.fromkeys(pairs)
            if self._plan_key(*pr) not in self._cache
        ]
        self.misses += len(missing)
        self.hits += len(pairs) - len(missing)
        for pr, plan in zip(missing, self._build_many(missing)):
            self._cache[self._plan_key(*pr)] = plan
        return [self._cache[self._plan_key(*pr)] for pr in pairs]

    def _build_many(
        self, pairs: Sequence[Tuple[int, float]]
    ) -> List[GroupPlan]:
        """Run selection for ``pairs`` and derive their wave plans: one
        ``selector.select_many`` call (the batched planner) for several
        pairs, the serial ``selector.select`` for one. Does not touch the
        cache or the hit/miss counters — callers decide how builds are
        accounted.
        """
        if not pairs:
            return []
        K = self.num_classes
        if len(pairs) > 1:
            ps = np.stack(
                [self.estimator.clusters[c].p_hat for c, _ in pairs]
            )
            budgets = np.asarray([bg for _, bg in pairs], np.float64)
            sels = self.selector.select_many(ps, K, budgets)
        else:
            (c, bg), = pairs
            sels = [self.selector.select(self.estimator.clusters[c].p_hat, K, bg)]
        return [
            self._derive(self.estimator.clusters[c].p_hat, sel)
            for (c, _), sel in zip(pairs, sels)
        ]

    def _derive(self, p: np.ndarray, sel) -> GroupPlan:
        """(cluster p-vector, SelectionResult) -> the derived wave plan."""
        K = self.num_classes
        pc = clip_probs(p)
        # identical ordering to adaptive_invoke: stable sort on clipped p
        order = np.asarray(sorted(list(sel.chosen), key=lambda i: -pc[i]), np.int64)
        w_order = log_weight(pc, K)[order]
        # residual log F exactly as the sequential loop sums it each round
        residual = np.asarray(
            [np.sum(w_order[t:]) for t in range(order.size)], np.float64
        )
        wave_costs = np.asarray(self.engine.costs, np.float64)[order]
        return GroupPlan(
            order=order,
            weights=w_order,
            residual=residual,
            wave_costs=wave_costs,
            empty=empty_log_belief(pc),
            planned=float(wave_costs.sum()) if order.size else 0.0,
        )

    def batch_tables(
        self, budget: float, idx: Optional[np.ndarray] = None
    ) -> BatchTables:
        """Stacked wave tables over all known clusters at ``budget``.

        The batch-level "plan once, route many" cache: built from the
        per-pair plans on first use (counting their hits/misses), then a
        uniform-budget batch routes via one cached table gather — zero
        selector work, zero per-group Python. Invalidates with the pool
        fingerprint like every plan.

        ``idx`` (optional (B,) dense cluster indices of the batch): a cache
        hit counts one plan hit per cluster the batch actually contains
        (every cluster without it)."""
        key = (float(budget), self._cost_fp, self._estimator_version())
        tables = self._table_cache.get(key)
        if tables is not None:
            if idx is None:
                self.hits += tables.order.shape[1]
            else:
                self.hits += int(np.unique(idx).size)
            return tables
        cids = getattr(self.estimator, "cluster_order", None)
        if cids is None:
            cids = np.asarray(sorted(self.estimator.clusters))
        # cold tables = one batched-planner call over every cluster
        plans = self.plan_many([(int(c), float(budget)) for c in cids])
        order, floats, empty, planned = stack_plans(plans)
        tables = BatchTables(
            order=order, floats=floats, empty=empty, planned=planned,
            cluster_ids=np.asarray(cids, np.int64),
        )
        self._table_cache[key] = tables
        return tables

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        """Cache counters: hits/misses across lookups, invalidations, size."""
        return {
            "plan_hits": self.hits,
            "plan_misses": self.misses,
            "plan_invalidations": self.invalidations,
            "plan_cache_size": len(self._cache),
            "plan_stale_dropped": self.stale_dropped,
        }
