"""Plan-cache selection service: "plan once, route many" (host numpy; the
PyTorch port's copy of ``repro/serving/plans.py``; the compile cache it
warms in the reference has no counterpart in an eagerly run port).

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
Online feedback (``serving/feedback.py``) bumps cluster versions only for
clusters whose estimates actually drifted, so feedback that confirms
current estimates keeps every cache hot.

Hot-pair precomputation: the service counts how often each (cluster,
budget) pair is planned; :meth:`prewarm` builds plans ahead of traffic for
an explicit list of pairs or for the hottest pairs seen so far, so a
serving replica can warm its cache before taking load (or after an
invalidation) without paying selection latency on user queries.
"""
from __future__ import annotations

import dataclasses
from collections import Counter
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

    Misses are **batched**: every multi-pair entry point (:meth:`plan_many`,
    :meth:`batch_tables`, :meth:`prewarm`, :meth:`prefetch_for`,
    :meth:`replan_stale`) funnels its missing (cluster, budget) pairs into
    one :meth:`~repro_torch.core.selection.ThriftLLM.select_many` call, so a
    cache-miss storm — a cold replica warming up, a drift fold invalidating
    many clusters at once — costs one batched-planner dispatch instead of a
    serial selection per pair. ``batched=False`` pins the serial per-pair
    path (the benchmark baseline); both produce bit-identical plans under
    the planner's shared-CRN contract.
    """

    def __init__(self, selector, estimator, engine, num_classes: int,
                 batched: bool = True):
        self.selector = selector
        self.estimator = estimator
        self.engine = engine
        self.num_classes = int(num_classes)
        self.batched = bool(batched)
        self._cache: Dict[PlanKey, GroupPlan] = {}
        self._table_cache: Dict[Tuple[float, bytes, int], BatchTables] = {}
        self._pair_counts: Counter = Counter()
        # (cluster, budget) pairs whose plans the stale-prune dropped —
        # the batched drift-replan's work list (see replan_stale)
        self._replan_pairs: set = set()
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        self.prefetches = 0
        self.stale_dropped = 0
        self.batch_replans = 0
        self.batch_replanned = 0
        self._cost_fp = self.engine.fingerprint()
        self._plan_version = self._estimator_version()

    # ------------------------------------------------------------------
    # Pool identity
    # ------------------------------------------------------------------
    def _estimator_version(self) -> int:
        """The estimator's global plan version — bumped whenever any
        cluster's estimate changes in a plan-visible way (a direct
        ``update`` call, or drifting feedback; confirming feedback leaves
        it put). Batch-table keys carry it; per-pair plan keys carry the
        finer per-cluster version. NOTE: assigning ``p_hat`` directly
        bypasses the version machinery — follow such edits with
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
        and prunes the dead entries so the cache doesn't grow unboundedly
        under continuous feedback. A *cost* change (re-priced or swapped
        arms) is handled eagerly because the selector's internal cost
        snapshot must be re-pulled from the engine before the next build.
        """
        cost_fp = self.engine.fingerprint()
        plan_version = self._estimator_version()
        if cost_fp == self._cost_fp and plan_version == self._plan_version:
            return False
        if cost_fp != self._cost_fp:
            self._cache.clear()
            self._table_cache.clear()
            self._pair_counts.clear()
            self._replan_pairs.clear()   # re-priced pool: nothing to rebuild
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
        dropped; accumulated in ``stale_dropped`` — the replan counter the
        serving stats expose, since every pruned plan is one the feedback
        loop forced a re-selection of."""
        live = [k for k in self._cache if k == self._plan_key(k[0], k[1])]
        dropped = len(self._cache) - len(live)
        if dropped:
            live_set = set(live)
            self._replan_pairs.update(
                (k[0], k[1]) for k in self._cache if k not in live_set
            )
            self._cache = {k: self._cache[k] for k in live}
        version = self._estimator_version()
        self._table_cache = {
            k: v for k, v in self._table_cache.items()
            if k[1] == self._cost_fp and k[2] == version
        }
        # the selector memoizes on p-vector bytes: entries for dead
        # estimates can never hit again, so bound them too or continuous
        # drift grows the memo forever (oldest-first, live plans stay)
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
        self._pair_counts[key[:2]] += 1
        plan = self._cache.get(key)
        if plan is not None:
            self.hits += 1
            return plan
        self.misses += 1
        plan = self._build(int(cid), float(budget))
        self._cache[key] = plan
        return plan

    def plan_many(self, pairs: Iterable[Tuple[int, float]]) -> List[GroupPlan]:
        """Wave plans for many (cluster, budget) pairs; one batched
        selection dispatch covers every miss.

        The multi-pair mirror of :meth:`plan` (same hit/miss accounting,
        same cache): cached pairs gather for free, the missing ones are
        selected together through the batched planner. This is the
        cache-miss-storm entry point — a cold batch table, a prewarm, a
        drift replan of many clusters — turning O(misses) serial SurGreedy
        runs into one device program. Returns plans aligned with ``pairs``.
        """
        pairs = [(int(c), float(bg)) for c, bg in pairs]
        for pr in pairs:
            self._pair_counts[pr] += 1
        missing = [
            pr for pr in dict.fromkeys(pairs)
            if self._plan_key(*pr) not in self._cache
        ]
        self.misses += len(missing)
        self.hits += len(pairs) - len(missing)
        for pr, plan in zip(missing, self._build_many(missing)):
            self._cache[self._plan_key(*pr)] = plan
        return [self._cache[self._plan_key(*pr)] for pr in pairs]

    def _build(self, cid: int, budget: float) -> GroupPlan:
        return self._build_many([(int(cid), float(budget))])[0]

    def _build_many(
        self, pairs: Sequence[Tuple[int, float]]
    ) -> List[GroupPlan]:
        """Run selection for ``pairs`` and derive their wave plans.

        With ``batched`` (default) every pair rides one
        ``selector.select_many`` call — one batched greedy program over
        the stacked (cluster, budget) groups; ``batched=False`` keeps the
        serial per-pair path (bit-identical results, used as the benchmark
        baseline). Does not touch the cache or the hit/miss counters —
        callers decide how builds are accounted.
        """
        if not pairs:
            return []
        K = self.num_classes
        # the batched program only pays off with groups to share; a single
        # pair takes the serial path (bit-identical under the CRN contract)
        if self.batched and len(pairs) > 1:
            ps = np.stack(
                [self.estimator.clusters[c].p_hat for c, _ in pairs]
            )
            budgets = np.asarray([bg for _, bg in pairs], np.float64)
            sels = self.selector.select_many(ps, K, budgets)
        else:
            sels = [
                self.selector.select(
                    self.estimator.clusters[c].p_hat, K, bg
                )
                for c, bg in pairs
            ]
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

    def replan_stale(self, clusters: Optional[Iterable[int]] = None) -> int:
        """Rebuild, as one batched dispatch, every plan the stale-prunes
        dropped — the drift-replan fast path.

        The scheduler calls this at the admission boundary right after a
        drifting feedback fold: :meth:`refresh` prunes the invalidated
        entries (recording their (cluster, budget) pairs), then all of them
        re-select through one :meth:`_build_many` call, so a fold that
        drifts G clusters costs one batched-planner dispatch instead of G
        cold selections on the next batches. ``clusters`` optionally
        restricts the rebuild; unrestricted pairs stay queued. Returns the
        number of plans rebuilt (also accumulated in ``batch_replanned``).
        """
        self.refresh()
        pending = sorted(self._replan_pairs)
        if clusters is not None:
            want = {int(c) for c in clusters}
            pending = [pr for pr in pending if pr[0] in want]
        self._replan_pairs.difference_update(pending)
        build = [
            pr for pr in pending
            if pr[0] in self.estimator.clusters
            and self._plan_key(*pr) not in self._cache
        ]
        if not build:
            return 0
        for pr, plan in zip(build, self._build_many(build)):
            self._cache[self._plan_key(*pr)] = plan
        self.batch_replans += 1
        self.batch_replanned += len(build)
        return len(build)

    def batch_tables(
        self, budget: float, idx: Optional[np.ndarray] = None
    ) -> BatchTables:
        """Stacked wave tables over all known clusters at ``budget``.

        The batch-level "plan once, route many" cache: built from the
        per-pair plans on first use (counting their hits/misses), then a
        uniform-budget batch routes via one cached table gather — zero
        selector work, zero per-group Python. Invalidates with the pool
        fingerprint like every plan.

        ``idx`` (optional (B,) dense cluster indices of the batch) feeds
        the traffic accounting: per-query (cluster, budget) counts keep
        :meth:`hot_pairs` meaningful, and a cache hit counts one plan hit
        per cluster the batch actually contains."""
        key = (float(budget), self._cost_fp, self._estimator_version())
        tables = self._table_cache.get(key)
        if tables is not None:
            if idx is None:
                self.hits += tables.order.shape[1]
            else:
                self.hits += self._note_traffic(tables, float(budget), idx)
            return tables
        cids = getattr(self.estimator, "cluster_order", None)
        if cids is None:
            cids = np.asarray(sorted(self.estimator.clusters))
        # cache-miss storm = one batched-planner dispatch (cold tables, or
        # a drift fold that invalidated many clusters at once)
        plans = self.plan_many([(int(c), float(budget)) for c in cids])
        order, floats, empty, planned = stack_plans(plans)
        tables = BatchTables(
            order=order, floats=floats, empty=empty, planned=planned,
            cluster_ids=np.asarray(cids, np.int64),
        )
        self._table_cache[key] = tables
        if idx is not None:
            self._note_traffic(tables, float(budget), idx)
        return tables

    def _note_traffic(
        self, tables: BatchTables, budget: float, idx: np.ndarray
    ) -> int:
        """Fold a batch's per-query (cluster, budget) counts into the
        hot-pair tracker; returns how many distinct clusters the batch hit."""
        counts = np.bincount(idx, minlength=tables.cluster_ids.size)
        present = 0
        for c, n in zip(tables.cluster_ids, counts):
            if n:
                self._pair_counts[(int(c), budget)] += int(n)
                present += 1
        return present

    # ------------------------------------------------------------------
    # Precomputation ahead of traffic
    # ------------------------------------------------------------------
    def hot_pairs(self, n: int = 16) -> List[Tuple[int, float]]:
        """The ``n`` most frequently planned (cluster, budget) pairs."""
        return [pair for pair, _ in self._pair_counts.most_common(n)]

    def known_budgets(self) -> List[float]:
        """Every budget observed in planned traffic, ascending — the
        default downgrade ladder for cost-ledger admission (a downgraded
        request lands on a budget that already has warm plans)."""
        return sorted({float(b) for _, b in self._pair_counts})

    def prewarm(
        self,
        pairs: Optional[Iterable[Tuple[int, float]]] = None,
        budgets: Optional[Sequence[float]] = None,
        top: int = 16,
    ) -> int:
        """Build plans ahead of traffic; returns the number of plans built.

        Three modes:
          * ``pairs`` given — plan exactly those (cluster, budget) pairs;
          * ``budgets`` given — plan the cross product of every known
            cluster with each budget (cold-start warmup);
          * neither — re-plan the ``top`` hottest pairs observed so far
            (post-invalidation warmup; the hot-pair snapshot is taken
            *before* refreshing, so it survives a cost invalidation).
        """
        hot_before = self.hot_pairs(top) if pairs is None and budgets is None else None
        self.refresh()
        if pairs is None:
            if budgets is not None:
                pairs = [
                    (int(c), float(b))
                    for c in self.estimator.clusters
                    for b in budgets
                ]
            else:
                pairs = hot_before
        build = [
            pr for pr in dict.fromkeys(
                (int(c), float(bg)) for c, bg in pairs
            )
            if pr[0] in self.estimator.clusters
            and self._plan_key(*pr) not in self._cache
        ]
        for pr, plan in zip(build, self._build_many(build)):
            self._cache[self._plan_key(*pr)] = plan
        return len(build)

    def prefetch_for(self, embeddings: np.ndarray, budgets: np.ndarray) -> int:
        """Queue-composition plan prefetch: given the (embedding, budget)
        columns of a *pending* request queue, map them to clusters and build
        whatever (cluster, budget) plans the coming flush will need — plus
        the stacked batch tables when the composition is uniform-budget (the
        common serving case). Called by the scheduler while a batch is
        accumulating, so SurGreedy selection latency is paid before the
        flush deadline instead of on the routed batch. Returns the number
        of plans built; counts them as prefetches, not misses.
        """
        self.refresh()
        embeddings = np.asarray(embeddings, np.float64)
        if embeddings.shape[0] == 0:
            return 0
        idx = self.estimator.lookup_batch_indices(embeddings)
        cids = self.estimator.cluster_order[idx]
        budgets = np.asarray(budgets, np.float64)
        build = [
            pr for pr in sorted(
                {(int(c), float(b)) for c, b in zip(cids, budgets)}
            )
            if self._plan_key(*pr) not in self._cache
        ]
        for pr, plan in zip(build, self._build_many(build)):
            self._cache[self._plan_key(*pr)] = plan
        self.prefetches += len(build)
        if (budgets == budgets[0]).all():
            self.batch_tables(float(budgets[0]))
        return len(build)

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        """Cache counters: hits/misses across lookups, invalidations, size."""
        return {
            "plan_hits": self.hits,
            "plan_misses": self.misses,
            "plan_invalidations": self.invalidations,
            "plan_prefetches": self.prefetches,
            "plan_cache_size": len(self._cache),
            "plan_stale_dropped": self.stale_dropped,
            "plan_batch_replans": self.batch_replans,
            "plan_batch_replanned": self.batch_replanned,
        }
