"""R-replica serving plane: replicated wave engines, shared control plane.

Host numpy over the port's router and scheduler; the PyTorch port's copy
of ``repro/serving/replica.py``, name for name. It carves the serving stack
into a replicated data plane and one shared control plane:

* **Data plane — replicated, with three placements.** A
  :class:`ReplicaWorker` is one
  :class:`~repro_torch.serving.scheduler.BatchScheduler` over its own
  :class:`~repro_torch.serving.router.ThriftRouter` clone. How the
  workers' wave programs reach the card is ``ReplicaSet(placement=...)``:

  - ``"overlapped"`` (default with more than one CUDA device) — each
    worker launches its wave programs on its own execution queue: its own
    card where there are several
    (:func:`~repro_torch.distributed.sharding.replica_devices` round-robins
    them), else a ``torch.cuda.Stream`` of its own that the set creates.
    Every drive cycle launches each worker's wave program asynchronously
    and the R device programs overlap while the host finalizes in arrival
    order; a retiring route's readback waits for its stream's event. Per-
    worker fault draws carry the worker's fused-concatenation row offset,
    so overlapped routes are bit-identical to the fused dispatch of the
    same admission wave, faults included. On the CPU the workers launch
    in the same order, one after another.
  - ``"fused"`` (default with one device) — same-budget staged groups from
    several workers concatenate into ONE ``begin_route`` along the batch
    axis, and each worker adopts a :class:`_RouteView` slice of the fused
    route.
  - ``"inline"`` (the R=1 default) — each worker launches its own groups
    the instant they admit, exactly like a standalone scheduler; this is
    the bit-identity anchor against :class:`BatchScheduler`.
* **Admission — sharded by cluster affinity.** ``submit_many`` scatters a
  columnar block across workers by a splitmix hash of each query's
  cluster index, so one cluster's traffic keeps hitting one replica and
  its plan reads stay hot; when the hash overloads a replica (skewed
  traffic), the overflow *spills* to the least-loaded replica
  (``replica_spills`` counts it). One caller-visible
  :class:`~repro_torch.serving.scheduler.BlockFuture` spans all shards via
  the ``submit_block`` seam.
* **Control plane — shared.** All workers route against ONE
  :class:`~repro_torch.serving.plans.PlanService` (drifted clusters replan
  once, centrally, through the batched ``plan_many`` dispatch), ONE
  :class:`~repro_torch.serving.scheduler.CostLedger` (per-tenant budgets
  and QPS limits enforced at each worker's admission, settled per replica
  at retire), and ONE central :class:`~repro_torch.serving.feedback.FeedbackLog`
  that is the request-id authority. Each worker observes outcomes into a
  replica-local log; at admission boundaries the set exports every local
  log's pending counts as a :class:`~repro_torch.serving.feedback.FeedbackShard`,
  :func:`~repro_torch.serving.feedback.merge_counts` adds them (exact —
  counts are monotone integer sums), and the merged shard folds through
  ONE central ``apply``. Plans, plan tables and selections are host numpy,
  so no worker reads another worker's device buffers.

**R=1 equivalence contract.** ``ReplicaSet(router, replicas=1)`` is
bit-identical to ``BatchScheduler(router)`` on the same stream:
predictions, costs, stats counters, plan hit rates, feedback folds,
ledger settlement. Worker 0 *is* the given router; fusion is off at R=1;
the local feedback log clones the central log's parameters (same probe
rng stream); retirement order is the same FIFO.

**Fused-dispatch caveat.** Fusing concatenates batches, which changes
each row's batch index — and injected fault draws hash on (arm, wave,
row index), so a fused route under an active
:class:`~repro_torch.distributed.fault.FaultPolicy` draws different
(equally deterministic) faults than the same rows dispatched unfused. The
overlapped placement passes each worker's concatenation offset as
``fault_row_offset``, so fused and overlapped placements of the same
admission wave draw the *same* faults cell for cell.

**Overlapped ≡ fused equivalence caveat.** The per-request bit-identity
between the two holds for deterministic (tabular / self-hosted) arms. A
*pooled* oracle engine draws responses from one shared rng stream that
advances per engine call, so one fused call and R per-worker calls
consume the stream differently.

Differences from the reference: the port has no ``jit``, so
``prewarm_compile`` and the compile-cache seams have no counterpart; a
router's ``device`` is where its wave loop runs (the reference's pin of
``None`` is the router's own device here); ``replica_mesh`` waits for the
port's distribution tools.
"""
from __future__ import annotations

import contextlib
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch import trace
from repro_torch.distributed.fault import FAULT_ERROR, FAULT_TIMEOUT, _mix64
from repro_torch.distributed.sharding import replica_devices

from .feedback import FeedbackLog, FeedbackReport, merge_counts
from .router import RouteResult, ThriftRouter
from .scheduler import BatchScheduler, BlockFuture, CostLedger, _Group

__all__ = ["ReplicaSet", "ReplicaWorker"]

#: scheduler-core counters summed across workers by ``ReplicaSet.stats``
#: (everything else in a worker's stats dict mirrors a *shared* subsystem
#: — plans/ledger — or a per-worker one aggregated separately)
_CORE_STATS = (
    "batches", "requests", "flushes", "submitted", "completed",
    "spec_jit", "spec_reference", "inflight_peak",
)

#: non-None sentinel for _RouteView.rng: the retire path steps a
#: reference-kind route wave by wave only when its rng is None, and a
#: fused view must always take the blocking result() branch (its parent
#: is shared — per-slice stepping would interleave wavefronts)
_FUSED = object()


def _affinity_shard(cluster_idx: np.ndarray, replicas: int) -> np.ndarray:
    """Cluster-affinity hash: dense cluster index -> replica id, via the
    splitmix64 finalizer (stateless, well-mixed even for the small dense
    index ranges clustering produces)."""
    with np.errstate(over="ignore"):      # uint64 wraparound IS the hash
        h = _mix64(
            np.asarray(cluster_idx, np.uint64) + np.uint64(0x9E3779B97F4A7C15)
        )
    return (h % np.uint64(replicas)).astype(np.int64)


class _ShardLog(FeedbackLog):
    """Replica-local feedback log.

    Observes/records/probes exactly like a standalone log — same
    parameters as the central log, probe rng decorrelated by worker index
    (worker 0 keeps the central seed, preserving the R=1 stream) — but the
    central log stays the request-id authority (ids must be unique across
    the whole set) and this log never applies: the control plane exports
    its pending counts as a shard and folds them centrally.
    """

    def __init__(self, central: FeedbackLog, worker: int):
        super().__init__(
            central.estimator,
            delta=central.delta,
            drift_delta=central.drift_delta,
            max_watch=central.max_watch,
            probe_rate=central.probe_rate,
            probe_seed=central.probe_seed + worker,
        )
        self._central = central

    def next_ids(self, n: int) -> np.ndarray:
        return self._central.next_ids(n)


class _StagedGroup:
    """One admitted budget group a worker deferred instead of launching."""

    __slots__ = ("payloads", "emb", "budgets", "arrival", "part_sinks",
                 "part_id", "part_pos", "ids", "tenants", "reserved", "mode")

    def __init__(self, payloads, emb, budgets, arrival, part_sinks, part_id,
                 part_pos, ids, tenants, reserved, mode):
        self.payloads = payloads
        self.emb = emb
        self.budgets = budgets
        self.arrival = arrival
        self.part_sinks = part_sinks
        self.part_id = part_id
        self.part_pos = part_pos
        self.ids = ids
        self.tenants = tenants
        self.reserved = reserved
        self.mode = mode

    @property
    def n(self) -> int:
        return self.budgets.shape[0]


def _slice_result(res: RouteResult, lo: int, hi: int, L: int) -> RouteResult:
    """Row slice [lo, hi) of a fused RouteResult, with the per-batch
    aggregates (arm counts, wave depth, fault counts) recomputed for the
    slice so a worker's accounting sees only its own rows."""
    schedule = res.schedule[lo:hi]
    invoked = res.invoked[lo:hi]
    kw = {}
    if res.fault_codes is not None:
        fsched = res.fault_schedule[lo:hi]
        fcodes = res.fault_codes[lo:hi]
        hit = (fcodes == FAULT_TIMEOUT) | (fcodes == FAULT_ERROR)
        kw = dict(
            fault_schedule=fsched,
            fault_codes=fcodes,
            arm_fault_counts=np.bincount(fsched[hit], minlength=L),
        )
    return RouteResult(
        predictions=res.predictions[lo:hi],
        costs=res.costs[lo:hi],
        planned_costs=res.planned_costs[lo:hi],
        clusters=res.clusters[lo:hi],
        budgets=np.asarray(res.budgets)[lo:hi],
        schedule=schedule,
        responses=res.responses[lo:hi],
        invoked=invoked,
        arm_query_counts=np.bincount(schedule[invoked], minlength=L),
        waves=int(invoked.any(axis=0).sum()) if invoked.size else 0,
        **kw,
    )


class _RouteView:
    """A worker's slice of one fused PendingRoute.

    Quacks like the PendingRoute surface the retire path touches: ``kind``
    / ``plan_version`` / ``spec_cost`` proxy the parent, ``payloads`` is
    the worker's own row slice (the probe side channel invokes with
    group-relative rows), ``ready()`` polls the shared device program and
    ``result()`` caches a row slice of the parent's RouteResult. ``rng``
    is a non-None sentinel so the retire path never wave-steps a view.
    """

    __slots__ = ("_parent", "_lo", "_hi", "_L", "rng", "_res")

    def __init__(self, parent, lo: int, hi: int, L: int):
        self._parent = parent
        self._lo = lo
        self._hi = hi
        self._L = L
        self.rng = _FUSED
        self._res: Optional[RouteResult] = None

    @property
    def kind(self) -> str:
        return self._parent.kind

    @property
    def plan_version(self) -> int:
        return self._parent.plan_version

    @property
    def spec_cost(self) -> float:
        return self._parent.spec_cost

    @property
    def payloads(self):
        return self._parent.payloads[self._lo:self._hi]

    def ready(self) -> bool:
        return self._parent.ready()

    def result(self) -> RouteResult:
        if self._res is None:
            self._res = _slice_result(
                self._parent.result(), self._lo, self._hi, self._L
            )
        return self._res


class _WorkerScheduler(BatchScheduler):
    """Per-replica BatchScheduler with the two seams a ReplicaSet drives:
    feedback folds route through the control plane's shard merge, and the
    dispatch launch can be deferred so the set can fuse same-budget groups
    from several workers into one wave program."""

    def __init__(self, *args, **kwargs):
        self._control: Optional["ReplicaSet"] = None
        self._defer_dispatch = False
        self._staged: List[_StagedGroup] = []
        super().__init__(*args, **kwargs)

    def apply_feedback(self) -> Optional[FeedbackReport]:
        if self._control is None:
            return super().apply_feedback()
        return self._control.merge_apply()

    def _launch(self, payloads, emb, budgets, arrival, part_sinks, part_id,
                part_pos, ids, tenants, reserved, mode):
        if self._defer_dispatch:
            self._staged.append(_StagedGroup(
                payloads, emb, budgets, arrival, part_sinks, part_id,
                part_pos, ids, tenants, reserved, mode,
            ))
            return
        super()._launch(payloads, emb, budgets, arrival, part_sinks, part_id,
                        part_pos, ids, tenants, reserved, mode)

    def _adopt(self, view, g: _StagedGroup, trace_group: int) -> None:
        """Take ownership of one slice of a fused dispatch (the deferred
        half of :meth:`_launch`); ``trace_group`` numbers the dispatch's
        spans."""
        self._stats["spec_" + view.kind] += 1
        self._stats["batches"] += 1
        self._inflight.append(_Group(
            view, g.arrival, g.part_sinks, g.part_id, g.part_pos,
            ids=g.ids, tenants=g.tenants, reserved=g.reserved,
            trace_group=trace_group,
        ))
        self._stats["inflight_peak"] = max(
            self._stats["inflight_peak"], len(self._inflight)
        )


class ReplicaWorker:
    """One replica of the serving data plane: a router clone (sharing the
    set's PlanService/selector) driven by a :class:`_WorkerScheduler`,
    optionally pinned to a card (``device``) and, in overlapped placement
    on a card, launching on a CUDA stream of its own (``stream``)."""

    __slots__ = ("index", "router", "sched", "device", "stream")

    def __init__(self, index: int, router: ThriftRouter,
                 sched: _WorkerScheduler, device=None, stream=None):
        self.index = index
        self.router = router
        self.sched = sched
        self.device = device
        self.stream = stream

    @property
    def backlog(self) -> int:
        """Queued + in-flight requests — the spill load signal."""
        return self.sched._qlen + sum(g.n for g in self.sched._inflight)


class ReplicaSet:
    """Sharded admission front-end over R replica workers.

    Drop-in for the streaming half of :class:`BatchScheduler`: ``submit``
    / ``submit_many`` / ``pump`` / ``drain`` / ``record_outcome(s)`` /
    ``apply_feedback`` / ``stats`` / ``latency_stats`` all exist with the
    same semantics (the one-shot ``flush()`` API intentionally does not —
    batch callers want a single scheduler).

    Args:
      router: the data-plane template. Worker 0 uses it as-is; workers
        1..R-1 get clones sharing its engine, estimator, selector and
        PlanService (the shared control plane), on its device.
      replicas: R. ``replicas=1`` is bit-identical to ``BatchScheduler``.
      placement: how worker wave programs reach the card —
        ``"overlapped"`` (each worker launches on its own card, or on its
        own CUDA stream of one card, all overlapped), ``"fused"``
        (same-budget groups concatenate into one dispatch), or
        ``"inline"`` (each worker launches alone, the standalone-scheduler
        cadence). Default (None): R=1 picks ``"inline"`` (the bit-identity
        anchor), R>1 picks ``"overlapped"`` when the router's device type
        has more than one device and ``"fused"`` otherwise.
      spill_factor: a replica may be assigned at most
        ``ceil(spill_factor * n / R)`` rows of one admitted block by
        affinity; the excess spills row by row to the least-loaded other
        replicas (never back to the over-cap home).
      feedback / ledger / remaining kwargs: as on :class:`BatchScheduler`
        (``max_batch`` etc. apply per worker; ``feedback``/``ledger``
        instances are shared set-wide).
    """

    def __init__(
        self,
        router: ThriftRouter,
        replicas: int = 2,
        *,
        max_batch: int = 64,
        max_wait_s: float = 0.02,
        max_inflight: int = 2,
        speculation: str = "auto",
        speculation_threshold: float = 0.0,
        slo_margin_s: float = 0.002,
        prefetch_plans: bool = True,
        coalesce: int = 1,
        feedback=None,
        ledger=None,
        budget_tiers=None,
        placement: Optional[str] = None,
        spill_factor: float = 1.5,
    ):
        replicas = int(replicas)
        if replicas < 1:
            raise ValueError("replicas must be >= 1")
        self.replicas = replicas
        self.router = router
        self.estimator = router.estimator
        self.plans = router.plans
        if feedback is True:
            feedback = FeedbackLog(router.estimator)
        self.feedback: Optional[FeedbackLog] = feedback or None
        if ledger is True:
            ledger = CostLedger(num_arms=len(router.engine.arms))
        self.ledger: Optional[CostLedger] = ledger or None
        devices = replica_devices(replicas, router.device)
        if placement is None:
            if replicas == 1:
                placement = "inline"
            elif devices[0] is not None:
                placement = "overlapped"
            else:
                placement = "fused"
        if placement not in ("overlapped", "fused", "inline"):
            raise ValueError(f"unknown placement {placement!r}")
        self.placement = placement
        self.fuse_waves = placement == "fused"
        self.spill_factor = float(spill_factor)
        self.speculation_threshold = float(speculation_threshold)
        self._next_id = 0
        self.spills = 0
        self.fused_dispatches = 0
        self.fused_rows = 0
        self.overlapped_dispatches = 0
        self.overlapped_rows = 0
        self.device_count = len({str(d) for d in devices if d is not None}) or 1
        self.workers: List[ReplicaWorker] = []
        for i in range(replicas):
            r = router if i == 0 else self._clone_router(router)
            # per-worker card pin: in overlapped placement the worker's wave
            # programs run on its own card; other placements put a reused
            # router back on its home device (where its selector plans)
            pin = devices[i] if placement == "overlapped" else None
            r.device = pin if pin is not None else torch.device(r.selector.device)
            stream = (
                torch.cuda.Stream(device=r.device)
                if placement == "overlapped" and r.device.type == "cuda" else None
            )
            local = (
                _ShardLog(self.feedback, worker=i)
                if self.feedback is not None else None
            )
            sched = _WorkerScheduler(
                r, max_batch=max_batch, max_wait_s=max_wait_s,
                max_inflight=max_inflight, speculation=speculation,
                speculation_threshold=speculation_threshold,
                slo_margin_s=slo_margin_s, prefetch_plans=prefetch_plans,
                coalesce=coalesce, feedback=local, ledger=self.ledger,
                budget_tiers=budget_tiers,
            )
            sched._control = self
            self.workers.append(ReplicaWorker(i, r, sched, devices[i], stream))

    @staticmethod
    def _clone_router(router: ThriftRouter) -> ThriftRouter:
        """A data-plane clone: own begin_route entry (so per-worker wave
        dispatches interleave), shared engine/estimator/selector and —
        the control-plane contract — shared PlanService."""
        clone = ThriftRouter(
            router.engine, router.estimator, router.num_classes,
            use_kernel=router.use_kernel, jit_waves=router.jit_waves,
            failover=router.failover, plan_service=router.plans,
            device=router.device,
        )
        clone.selector = router.selector
        return clone

    # ------------------------------------------------------------------
    # Sharded admission
    # ------------------------------------------------------------------
    def _alloc_ids(self, n: int) -> np.ndarray:
        if self.feedback is not None:
            return self.feedback.next_ids(n)
        start = self._next_id
        self._next_id += n
        return np.arange(start, start + n, dtype=np.int64)

    def _assign(self, emb: np.ndarray, n: int) -> np.ndarray:
        """Replica id per row: cluster-affinity hash, with per-block spill
        of the overflow beyond ``spill_factor`` x fair share to the least
        loaded replicas (affinity keeps plan reads hot; spill caps skew).

        Spill membership is decided once, from the pre-spill assignment:
        each over-cap replica keeps its FIFO prefix and sheds its tail.
        Spilled rows then place one at a time on the least-loaded *other*
        replica (a row can never land back on an over-cap home, and a row
        that already spilled is never re-spilled by a later overflow)."""
        R = self.replicas
        if R == 1:
            return np.zeros(n, np.int64)
        idx = self.estimator.lookup_batch_indices(emb)
        assign = _affinity_shard(idx, R)
        cap = int(np.ceil(self.spill_factor * n / R))
        counts = np.bincount(assign, minlength=R)
        over = np.flatnonzero(counts > cap)
        if over.size == 0:
            return assign
        load = np.asarray([w.backlog for w in self.workers], np.int64)
        # spill sets fixed from the ORIGINAL assignment; homes settle at cap
        spill_sets = [(r, np.flatnonzero(assign == r)[cap:]) for r in over]
        totals = load + np.minimum(counts, cap)
        big = np.iinfo(np.int64).max
        for r, spill in spill_sets:
            masked = totals.copy()
            masked[r] = big                     # never spill to self
            for row in spill:
                tgt = int(np.argmin(masked))
                assign[row] = tgt
                masked[tgt] += 1
                totals[tgt] += 1
            self.spills += int(spill.size)
        return assign

    def submit(self, req) -> Any:
        """Route one request to its affinity replica; returns that
        worker's RequestFuture (its ``result()`` drives the owning worker,
        which is all the request needs)."""
        emb = np.asarray(req.embedding, np.float64)[None, :]
        w = self.workers[int(self._assign(emb, 1)[0])] \
            if self.replicas > 1 else self.workers[0]
        return w.sched.submit(req)

    def submit_many(
        self,
        payloads,
        embeddings: np.ndarray,
        budgets,
        slo_s: Optional[float] = None,
        arrival_s=None,
        tenant="default",
    ) -> BlockFuture:
        """Columnar block admission, sharded: one caller-visible
        BlockFuture whose rows scatter across workers by cluster
        affinity (each worker fills its rows through the ``submit_block``
        seam)."""
        emb = np.asarray(embeddings, np.float64)
        n = emb.shape[0]
        if n == 0:
            return BlockFuture(self, 0)
        budgets = np.broadcast_to(np.asarray(budgets, np.float64), (n,)).copy()
        if arrival_s is None:
            arrival = np.full(n, time.monotonic())
        else:
            arrival = np.broadcast_to(
                np.asarray(arrival_s, np.float64), (n,)
            ).copy()
        slo = np.full(n, np.nan if slo_s is None else float(slo_s))
        ids = self._alloc_ids(n)
        blk = BlockFuture(self, n, request_ids=ids)
        tenants = np.broadcast_to(np.asarray(tenant, object), (n,)).copy()
        assign = self._assign(emb, n)
        for r in range(self.replicas):
            rows = np.flatnonzero(assign == r)
            if rows.size == 0:
                continue
            self.workers[r].sched.submit_block(
                BatchScheduler._index_payloads(payloads, rows),
                emb[rows], budgets[rows], arrival[rows], slo[rows],
                blk, rows, ids[rows], tenants[rows],
            )
        return blk

    # ------------------------------------------------------------------
    # Shared control plane: merged feedback folds
    # ------------------------------------------------------------------
    def merge_apply(self) -> Optional[FeedbackReport]:
        """The set-wide admission-boundary fold: export every replica's
        pending counts, :func:`merge_counts` them, fold the merged shard
        through ONE central apply, replan drifted clusters once via the
        shared PlanService. Gated exactly like the single-scheduler fold,
        so R=1 produces the same ``applies`` trajectory."""
        central = self.feedback
        if central is None:
            return None
        locals_ = [w.sched.feedback for w in self.workers]
        if not (central.has_pending or any(l.has_pending for l in locals_)):
            return None
        shards = [l.export_shard() for l in locals_ if l.has_pending]
        if shards:
            central.absorb_shard(merge_counts(*shards))
        report = central.apply()
        if report.drifted:
            self.plans.replan_stale(report.drifted)
        return report

    apply_feedback = merge_apply

    def record_outcome(self, request_id: int, label: int) -> bool:
        return self.record_outcomes([request_id], [label]) == 1

    def record_outcomes(self, request_ids, labels) -> int:
        """Route each ground-truth label to the replica watching its
        request id; ids no replica knows land on the central log (which
        counts them unmatched). Returns how many ids matched."""
        if self.feedback is None:
            raise RuntimeError(
                "feedback is disabled; construct ReplicaSet(..., feedback=True)"
            )
        ids = np.asarray(request_ids, np.int64).ravel()
        labs = np.asarray(labels, np.int64).ravel()
        per: List[List[List[int]]] = [[[], []] for _ in self.workers]
        stray_ids: List[int] = []
        stray_labs: List[int] = []
        for rid, lab in zip(ids.tolist(), labs.tolist()):
            for w in self.workers:
                if rid in w.sched.feedback._watch:
                    per[w.index][0].append(rid)
                    per[w.index][1].append(lab)
                    break
            else:
                stray_ids.append(rid)
                stray_labs.append(lab)
        matched = 0
        for w in self.workers:
            rids, rlabs = per[w.index]
            if rids:
                matched += w.sched.feedback.record_many(rids, rlabs)
        if stray_ids:
            self.feedback.record_many(stray_ids, stray_labs)
        return matched

    # ------------------------------------------------------------------
    # Gang driving
    # ------------------------------------------------------------------
    def _dispatch(self, due: List[ReplicaWorker]) -> None:
        """Admit one batch on each due worker. Inline placement: the
        worker launches the moment it admits (bit-identical to a
        standalone scheduler). Otherwise workers stage their budget
        groups, then per budget either the staged groups concatenate into
        one ``begin_route`` along the batch axis (fused) and each worker
        adopts its row-slice view, or each worker's group launches
        asynchronously on its own card or stream (overlapped) with its
        fused-concatenation row offset feeding the fault draws."""
        if self.placement == "inline":
            for w in due:
                w.sched._dispatch_batch()
            return
        staged: List[tuple] = []
        for w in due:
            s = w.sched
            s._defer_dispatch = True
            try:
                s._dispatch_batch()
            finally:
                s._defer_dispatch = False
            staged.extend((w, g) for g in s._staged)
            s._staged.clear()
        if not staged:
            return
        by_budget: Dict[float, List[tuple]] = {}
        for w, g in staged:
            # scheduler groups are uniform-budget by construction
            by_budget.setdefault(float(g.budgets[0]), []).append((w, g))
        for entries in by_budget.values():
            if self.placement == "overlapped":
                self._launch_overlapped(entries)
            elif len(entries) == 1:
                w, g = entries[0]
                w.sched._launch(
                    g.payloads, g.emb, g.budgets, g.arrival, g.part_sinks,
                    g.part_id, g.part_pos, g.ids, g.tenants, g.reserved,
                    g.mode,
                )
                w.sched._stats["inflight_peak"] = max(
                    w.sched._stats["inflight_peak"], len(w.sched._inflight)
                )
            else:
                self._launch_fused(entries)

    def _launch_overlapped(self, entries: List[tuple]) -> None:
        """Asynchronous per-worker dispatch of one budget's staged groups.

        Walks the entries in the same order the fused placement would
        concatenate them, launching each worker's wave program through its
        *own* router on its own card or CUDA stream — all R device
        programs are in flight before any result is consumed, so their
        device work overlaps while retirement stays in per-worker arrival
        order. Each launch carries the worker's concatenation offset as
        ``fault_row_offset``: under an active FaultPolicy the overlapped
        dispatch draws the same fault grid, cell for cell, as the fused
        dispatch of the same admission wave."""
        launched = []
        lo = 0
        for w, g in entries:
            ctx = (
                torch.cuda.stream(w.stream)
                if w.stream is not None else contextlib.nullcontext()
            )
            group = trace.new_group()
            with ctx:
                pending = w.router.begin_route(
                    g.payloads, g.emb, g.budgets, mode=g.mode,
                    speculation_threshold=self.speculation_threshold,
                    fault_row_offset=lo,
                )
            launched.append((w, g, pending, group))
            lo += g.n
        self.overlapped_dispatches += len(entries)
        self.overlapped_rows += lo
        for w, g, pending, group in launched:
            w.sched._adopt(pending, g, group)

    def _launch_fused(self, entries: List[tuple]) -> None:
        w0: ReplicaWorker = entries[0][0]
        payloads = BatchScheduler._cat_payloads([g.payloads for _, g in entries])
        emb = np.concatenate([g.emb for _, g in entries])
        budgets = np.concatenate([g.budgets for _, g in entries])
        group = trace.new_group()
        pending = w0.router.begin_route(
            payloads, emb, budgets, mode=entries[0][1].mode,
            speculation_threshold=self.speculation_threshold,
        )
        self.fused_dispatches += 1
        self.fused_rows += int(budgets.shape[0])
        L = len(w0.router.engine.arms)
        lo = 0
        for w, g in entries:
            hi = lo + g.n
            w.sched._adopt(_RouteView(pending, lo, hi, L), g, group)
            lo = hi

    def pump(self) -> int:
        """Non-blocking progress across all replicas: retire every group
        whose device work finished, gang-dispatch every due worker
        (fusing same-budget groups), prefetch plans for queued work."""
        done = 0
        while True:
            for w in self.workers:
                s = w.sched
                while s._inflight and s._inflight[0].pending.ready():
                    done += s._retire(s._inflight.popleft())
            due = [w for w in self.workers if w.sched.ready()]
            if not due:
                break
            for w in due:
                s = w.sched
                if len(s._inflight) >= s.max_inflight:
                    done += s._retire(s._inflight.popleft())
            self._dispatch(due)
        for w in self.workers:
            if w.sched._queue:
                w.sched._prefetch()
        return done

    def drain(self) -> int:
        """Run every replica's backlog dry (deadlines ignored). The fill
        pipelines / retire ONE head per worker cadence matches
        :meth:`BatchScheduler.drain` exactly — with a shared ledger, the
        interleaving of settlements between admissions is part of the R=1
        equivalence contract (each settle releases reserved headroom, so a
        different retire order admits a different row set near a cap)."""
        done = 0
        while any(w.sched._queue or w.sched._inflight for w in self.workers):
            while True:
                due = [
                    w for w in self.workers
                    if w.sched._queue
                    and len(w.sched._inflight) < w.sched.max_inflight
                ]
                if not due:
                    break
                self._dispatch(due)
            for w in self.workers:
                s = w.sched
                if s._inflight:
                    done += s._retire(s._inflight.popleft())
        return done

    def _force(self, fut) -> None:
        """BlockFuture.result() entry point for set-level blocks."""
        if not fut.done():
            self.drain()

    def reconcile_ledger(self) -> int:
        """Set-wide restart reconciliation of the shared ledger: release
        every id-tracked reservation no worker's queue or flight holds
        (see :meth:`BatchScheduler.reconcile_ledger`). One ledger pass —
        the live set is the union across workers."""
        if self.ledger is None:
            return 0
        live: List[int] = []
        for w in self.workers:
            for seg in w.sched._queue:
                if seg.ids is not None:
                    live.extend(np.asarray(seg.ids, np.int64).ravel().tolist())
            for group in w.sched._inflight:
                if group.ids is not None:
                    live.extend(np.asarray(group.ids, np.int64).ravel().tolist())
        return self.ledger.release_orphans(live)

    # ------------------------------------------------------------------
    # Aggregated observability
    # ------------------------------------------------------------------
    @property
    def stats(self) -> Dict[str, float]:
        """Set-wide counters: scheduler-core counters summed across
        workers; shared subsystems (plan cache, ledger) counted once;
        per-worker feedback/degradation counters summed (the central log
        contributes the fold counters). With R=1 this equals
        ``BatchScheduler.stats`` key for key, plus the ``replica_*``
        group."""
        out: Dict[str, float] = {k: 0 for k in _CORE_STATS}
        for w in self.workers:
            for k in _CORE_STATS:
                out[k] += w.sched._stats[k]
        out.update(self.plans.stats())
        if self.feedback is not None:
            fb: Dict[str, float] = {}
            for log in [self.feedback] + [w.sched.feedback for w in self.workers]:
                for k, v in log.stats().items():
                    fb[k] = fb.get(k, 0) + v
            out.update(fb)
            deg: Dict[str, float] = {}
            for w in self.workers:
                for k, v in w.sched.degradation.stats().items():
                    deg[k] = deg.get(k, 0) + v
            out.update(deg)
        if self.ledger is not None:
            out.update(self.ledger.stats())
        out["replicas"] = self.replicas
        out["replica_spills"] = self.spills
        out["replica_fused"] = self.fused_dispatches
        out["replica_fused_rows"] = self.fused_rows
        out["replica_devices"] = self.device_count
        out["replica_overlapped"] = self.overlapped_dispatches
        out["replica_overlapped_rows"] = self.overlapped_rows
        return out

    @property
    def arm_query_totals(self) -> np.ndarray:
        out = np.zeros_like(self.workers[0].sched.arm_query_totals)
        for w in self.workers:
            out += w.sched.arm_query_totals
        return out

    def latency_stats(self) -> Dict[str, float]:
        """Completion-latency summary pooled across every replica."""
        arrs = []
        count = 0
        for w in self.workers:
            count += int(w.sched._stats["completed"])
            if w.sched._latencies:
                w.sched._trim_latencies()
                arrs.append(w.sched._latencies[0])
        if not arrs:
            return {"count": 0}
        lat = np.concatenate(arrs)
        return {
            "count": count,
            "p50_s": float(np.percentile(lat, 50)),
            "p99_s": float(np.percentile(lat, 99)),
            "mean_s": float(lat.mean()),
            "max_s": float(lat.max()),
        }

    def stragglers(self) -> List[int]:
        """Arms any replica's mitigator currently flags."""
        out = set()
        for w in self.workers:
            out.update(w.sched.mitigator.stragglers())
        return sorted(out)

    # ------------------------------------------------------------------
    # Warmup
    # ------------------------------------------------------------------
    def prewarm(self, budgets: Optional[List[float]] = None) -> int:
        """Build wave plans ahead of traffic (once — the PlanService is
        shared, so every replica reads the same warm cache)."""
        return self.plans.prewarm(budgets=budgets)

    def next_deadline(self) -> Optional[float]:
        """Earliest admission deadline across replicas (None when idle)."""
        deadlines = [
            d for d in (w.sched.next_deadline() for w in self.workers)
            if d is not None
        ]
        return min(deadlines) if deadlines else None

    def ready(self) -> bool:
        return any(w.sched.ready() for w in self.workers)
