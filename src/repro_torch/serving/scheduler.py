"""Continuous-batching serving front-end with cost-aware speculation.

Host numpy over the port's router; the PyTorch port's copy of
``repro/serving/scheduler.py``. A streaming front-end shaped like the
serving systems the paper's setting implies (FrugalGPT's cascade server,
OptLLM's per-query assignment):

* **Admission queue** — ``submit``/``submit_many`` enqueue requests (block
  submission is columnar: one segment of arrays, no per-request object
  churn on the hot path) and return completion futures. The flush policy is
  arrival-time and SLO-aware: a batch is admitted when it fills
  ``max_batch``, when the oldest request has waited ``max_wait_s``, or when
  a request's ``slo_s`` deadline (minus the dispatch margin) comes due —
  whichever is earliest.
* **Pipelined budget-group waves** — each admitted batch splits into its
  budget groups and every group is dispatched through
  :meth:`ThriftRouter.begin_route`, which returns a :class:`PendingRoute`
  *before* the device program finishes. Up to ``max_inflight`` groups ride
  in flight at once (double-buffered by default): group *t+1*'s planning
  and speculative gather run while group *t*'s jitted wave program is still
  executing, and retirement prefers groups whose device work already
  finished.
* **Per-request completion futures** — callers hold a
  :class:`RequestFuture` (or a columnar :class:`BlockFuture`) instead of
  waiting for a batch return. Reference-mode groups are stepped wave by
  wave and each query's future completes as its Prop. 4 stop wave fires;
  jitted groups complete when their single fused program lands. Results
  carry per-request latency, realized cost, stop wave and the data-plane
  mode that served them.
* **Cost-aware speculation switch** — ``speculation="auto"`` (default)
  lets every group pick its data plane: the speculative jitted wave loop
  when the scheduled arms' marginal metered invocation cost
  (:meth:`ThriftRouter.speculation_cost`) is at most
  ``speculation_threshold``, the compacting ``route_batch_reference`` plane
  otherwise. Oracle/tabular/self-hosted pools therefore always jit;
  metered API pools never pay for speculatively gathered waves the stop
  rule would have cancelled.
* **Plan prefetch keyed by queue composition** — while the queue is
  filling (admission deadline not yet due), the scheduler snapshots the
  queued (cluster, budget) composition and asks the PlanService to build
  any missing wave plans (:meth:`PlanService.prefetch_for`), so selection
  latency is paid before the flush instead of on it. (A feedback fold at
  the next admission can obsolete a prefetched plan for a *drifted*
  cluster — the price of replanning, not a correctness issue.)
* **Online estimation feedback** — with ``feedback=True`` the scheduler
  registers every completed request's (cluster, invoked arms, responses)
  in a :class:`~repro_torch.serving.feedback.FeedbackLog`; ground truth reported
  later via :meth:`BatchScheduler.record_outcome` buffers per-(cluster,
  arm) success counts, which fold into the estimator at admission
  boundaries (never mid-wave), bump the estimator version, and — only for
  clusters whose estimates actually drifted (Wilson interval-overlap
  test) — lazily invalidate the version-keyed plan caches.

The one-shot API stays: ``flush()`` admits one batch,
routes it synchronously as a single heterogeneous-budget call and returns
``[(requests, RouteResult)]``; per-arm latency accounting still feeds the
StragglerMitigator exactly as before.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.distributed.fault import (
    FAULT_DEGRADE,
    FAULT_ERROR,
    FAULT_TIMEOUT,
    StragglerMitigator,
)

from .feedback import DegradationTracker, FeedbackLog, FeedbackReport


@dataclasses.dataclass
class Request:
    payload: Any
    embedding: np.ndarray
    budget: float
    arrival_s: float = dataclasses.field(default_factory=time.monotonic)
    slo_s: Optional[float] = None    # target completion deadline (rel. arrival)
    tenant: str = "default"          # cost-ledger accounting principal


class CostLedger:
    """Per-tenant spend accounting with hard budget enforcement.

    Reservation/settlement discipline: at *admission* the scheduler
    reserves each request's budget — the spend ceiling, since SurGreedy
    never selects past it (``planned_costs <= budgets`` by construction,
    and in-wave failover only ever re-routes to arms already inside the
    selected set). At *retire* the realized charge settles (attributed per
    arm from the effective post-failover schedule) and the reservation is
    released. ``spent + reserved <= limit`` therefore holds at every
    instant for every tenant — the hard-budget invariant the
    ``tests/test_torch_cost_ledger.py`` suite pins — and no admitted
    request can ever push a tenant past its limit, regardless of
    interleaving.

    Tenants materialize lazily at ``default_limit`` (infinite unless
    configured); :meth:`set_limit` tightens or relaxes a tenant any time.

    Beyond spend, each tenant may carry a **QPS rate limit**: a token
    bucket (:meth:`set_rate_limit` — ``rate_limit`` tokens/s refill, burst
    capacity, one token per admission attempt) checked at the admission
    boundary alongside the budget reservation. A rate-limited request is
    rejected exactly like a budget miss (prediction -1, zero cost,
    ``mode="rejected"``); no token, no downgrade — a downgraded request
    would still be a request. ``clock`` is injectable for deterministic
    tests; unlimited tenants (the default) never read it.

    The ledger also survives restarts: :meth:`snapshot` returns a
    JSON-serializable dict and :meth:`restore` rebuilds a ledger from it.
    Outstanding admission reservations are carried across (conservative:
    the restarted process may never settle them, but ``spent + reserved <=
    limit`` keeps holding, which is the invariant that matters); token
    buckets restart full (a restart is a quiet period). Reservations are
    tracked per request id, so the restarted scheduler then reconciles —
    :meth:`release_orphans` (or the scheduler-level
    ``reconcile_ledger()``) releases every carried reservation whose
    request is not in the live queue, restoring the tenant's headroom
    instead of holding it hostage forever.
    """

    def __init__(
        self,
        limits: Optional[Dict[str, float]] = None,
        default_limit: float = float("inf"),
        num_arms: int = 0,
        rate_limits: Optional[Dict[str, float]] = None,
        default_rate_limit: float = float("inf"),
        clock=time.monotonic,
    ):
        self.default_limit = float(default_limit)
        self.default_rate_limit = float(default_rate_limit)
        self.num_arms = int(num_arms)
        self.clock = clock
        self._t: Dict[str, Dict[str, Any]] = {}
        self.admitted = 0
        self.rejected = 0
        self.downgraded = 0
        self.rate_limited = 0
        for tenant, lim in (limits or {}).items():
            self.set_limit(tenant, lim)
        for tenant, qps in (rate_limits or {}).items():
            self.set_rate_limit(tenant, qps)

    def _tenant(self, tenant: str) -> Dict[str, Any]:
        ent = self._t.get(tenant)
        if ent is None:
            qps = self.default_rate_limit
            ent = self._t[tenant] = {
                "limit": self.default_limit,
                "reserved": 0.0,
                "reserved_n": 0,
                "spent": 0.0,
                "requests": 0,
                "rejected": 0,
                "downgraded": 0,
                "rate_limited": 0,
                "rate_limit": qps,
                "burst": self._default_burst(qps),
                "tokens": self._default_burst(qps),
                "stamp": None,
                "by_arm": np.zeros(self.num_arms, np.float64),
                # outstanding reservations by request id — what lets a
                # restarted scheduler release orphans it will never settle
                "resv": {},
            }
        return ent

    @staticmethod
    def _default_burst(qps: float) -> float:
        return max(1.0, float(qps)) if np.isfinite(qps) else float("inf")

    def set_limit(self, tenant: str, limit: float) -> None:
        self._tenant(tenant)["limit"] = float(limit)

    def set_rate_limit(self, tenant: str, qps: float,
                       burst: Optional[float] = None) -> None:
        """Configure a tenant's admission token bucket: ``qps`` tokens/s
        refill up to ``burst`` capacity (default ``max(1, qps)``); each
        admission attempt consumes one token. ``inf`` removes the limit."""
        ent = self._tenant(tenant)
        ent["rate_limit"] = float(qps)
        ent["burst"] = (
            self._default_burst(qps) if burst is None else float(burst)
        )
        ent["tokens"] = ent["burst"]   # fresh bucket starts full
        ent["stamp"] = None

    def allow_request(self, tenant: str) -> bool:
        """Admission-time QPS check: refill the tenant's token bucket from
        the clock, then take one token. True (no clock read, no state
        touched) for unlimited tenants — the default stays zero-overhead."""
        ent = self._tenant(tenant)
        rate = ent["rate_limit"]
        if not np.isfinite(rate):
            return True
        now = float(self.clock())
        if ent["stamp"] is not None:
            ent["tokens"] = min(
                ent["burst"], ent["tokens"] + (now - ent["stamp"]) * rate
            )
        ent["stamp"] = now
        if ent["tokens"] >= 1.0:
            ent["tokens"] -= 1.0
            return True
        return False

    def note_rate_limited(self, tenant: str) -> None:
        self._tenant(tenant)["rate_limited"] += 1
        self.rate_limited += 1

    def remaining(self, tenant: str) -> float:
        ent = self._tenant(tenant)
        return ent["limit"] - ent["spent"] - ent["reserved"]

    def try_reserve(self, tenant: str, amount: float,
                    request_id: Optional[int] = None) -> bool:
        """Reserve ``amount`` against the tenant's remaining headroom;
        False (nothing reserved) when it does not fit. With a
        ``request_id`` the reservation is tracked by id, so a restart can
        reconcile it against a live queue (:meth:`release_orphans`)."""
        ent = self._tenant(tenant)
        if amount > ent["limit"] - ent["spent"] - ent["reserved"]:
            return False
        ent["reserved"] += float(amount)
        ent["reserved_n"] += 1
        if request_id is not None:
            ent["resv"][int(request_id)] = float(amount)
        self.admitted += 1
        return True

    def settle(self, tenant: str, reserved: float, charged: float,
               arm_spend: Optional[np.ndarray] = None,
               requests: int = 1, request_ids=None) -> None:
        """Release an admission reservation and commit the realized charge
        (with its exact per-arm attribution). ``request_ids`` retires the
        matching id-tracked reservations (ids never tracked are ignored)."""
        ent = self._tenant(tenant)
        ent["reserved"] -= float(reserved)
        ent["reserved_n"] -= int(requests)
        if request_ids is not None and ent["resv"]:
            for rid in np.asarray(request_ids, np.int64).ravel().tolist():
                ent["resv"].pop(int(rid), None)
        if ent["reserved_n"] <= 0:
            # no reservation outstanding: snap the float residue of the
            # add-one-by-one / release-as-a-sum asymmetry to an exact zero
            ent["reserved"] = 0.0
            ent["reserved_n"] = 0
            ent["resv"].clear()
        ent["spent"] += float(charged)
        ent["requests"] += int(requests)
        if arm_spend is not None:
            if ent["by_arm"].size != np.asarray(arm_spend).size:
                ent["by_arm"] = np.zeros(np.asarray(arm_spend).size, np.float64)
            ent["by_arm"] += arm_spend
        self.admitted -= int(requests)

    def release_orphans(self, active_request_ids) -> int:
        """Release id-tracked reservations whose request is not alive.

        The restart reconciliation: :meth:`restore` conservatively carries
        the dead process's outstanding reservations (so ``spent + reserved
        <= limit`` cannot be violated by the handoff), but nothing will
        ever settle them — without reconciliation they shrink the tenant's
        budget forever. A restarted scheduler passes the request ids it
        actually holds (queued + in flight); every tracked reservation
        outside that set is released exactly (amounts were recorded per
        id, so no float residue leaks into ``reserved``). Returns the
        number of reservations released."""
        ids = list(active_request_ids)
        active = {
            int(r) for r in np.asarray(ids, np.int64).ravel().tolist()
        } if ids else set()
        released = 0
        for ent in self._t.values():
            orphans = [rid for rid in ent["resv"] if rid not in active]
            for rid in orphans:
                ent["reserved"] -= ent["resv"].pop(rid)
                ent["reserved_n"] -= 1
                self.admitted -= 1
                released += 1
            if ent["reserved_n"] <= 0:
                ent["reserved"] = 0.0
                ent["reserved_n"] = 0
                ent["resv"].clear()
        return released

    def note_rejected(self, tenant: str) -> None:
        self._tenant(tenant)["rejected"] += 1
        self.rejected += 1

    def note_downgraded(self, tenant: str) -> None:
        self._tenant(tenant)["downgraded"] += 1
        self.downgraded += 1

    def tenant(self, tenant: str) -> Dict[str, Any]:
        """Snapshot of one tenant's ledger row (copies, safe to mutate)."""
        ent = self._tenant(tenant)
        out = dict(ent)
        out["by_arm"] = ent["by_arm"].copy()
        out["resv"] = dict(ent["resv"])
        return out

    def tenants(self) -> Dict[str, Dict[str, Any]]:
        return {name: self.tenant(name) for name in self._t}

    @property
    def total_spent(self) -> float:
        return float(sum(e["spent"] for e in self._t.values()))

    @property
    def total_reserved(self) -> float:
        return float(sum(e["reserved"] for e in self._t.values()))

    def stats(self) -> Dict[str, float]:
        """Flat counters mirrored into ``BatchScheduler.stats``."""
        return {
            "ledger_tenants": len(self._t),
            "ledger_spent": self.total_spent,
            "ledger_reserved": self.total_reserved,
            "ledger_requests": int(sum(e["requests"] for e in self._t.values())),
            "ledger_rejected": self.rejected,
            "ledger_downgraded": self.downgraded,
            "ledger_rate_limited": self.rate_limited,
        }

    # ------------------------------------------------------------------
    # Persistence across restarts
    # ------------------------------------------------------------------
    @staticmethod
    def _enc(v: float):
        # strict-JSON safe: infinities (the unlimited defaults) -> None
        return None if not np.isfinite(v) else float(v)

    @staticmethod
    def _dec(v) -> float:
        return float("inf") if v is None else float(v)

    def snapshot(self) -> Dict[str, Any]:
        """JSON-serializable ledger state: per-tenant spend, outstanding
        reservations, limits and counters. ``json.dumps(ledger.snapshot())``
        round-trips through :meth:`restore` — the restart path the
        ``tests/test_torch_cost_ledger.py`` suite pins."""
        enc = self._enc
        return {
            "version": 1,
            "default_limit": enc(self.default_limit),
            "default_rate_limit": enc(self.default_rate_limit),
            "num_arms": self.num_arms,
            "admitted": self.admitted,
            "rejected": self.rejected,
            "downgraded": self.downgraded,
            "rate_limited": self.rate_limited,
            "tenants": {
                name: {
                    "limit": enc(ent["limit"]),
                    "reserved": ent["reserved"],
                    "reserved_n": ent["reserved_n"],
                    "spent": ent["spent"],
                    "requests": ent["requests"],
                    "rejected": ent["rejected"],
                    "downgraded": ent["downgraded"],
                    "rate_limited": ent["rate_limited"],
                    "rate_limit": enc(ent["rate_limit"]),
                    "burst": enc(ent["burst"]),
                    "by_arm": ent["by_arm"].tolist(),
                    # JSON object keys must be strings; restore re-ints them
                    "resv": {str(rid): amt for rid, amt in ent["resv"].items()},
                }
                for name, ent in self._t.items()
            },
        }

    @classmethod
    def restore(cls, payload: Dict[str, Any],
                clock=time.monotonic) -> "CostLedger":
        """Rebuild a ledger from a :meth:`snapshot` dict (parsed JSON).

        Spend, reservations, limits and counters come back exactly; token
        buckets restart full at their configured rate/burst (wall-clock
        bucket levels do not survive a process boundary meaningfully)."""
        dec = cls._dec
        led = cls(
            default_limit=dec(payload["default_limit"]),
            default_rate_limit=dec(payload.get("default_rate_limit")),
            num_arms=int(payload.get("num_arms", 0)),
            clock=clock,
        )
        led.admitted = int(payload.get("admitted", 0))
        led.rejected = int(payload.get("rejected", 0))
        led.downgraded = int(payload.get("downgraded", 0))
        led.rate_limited = int(payload.get("rate_limited", 0))
        for name, row in payload.get("tenants", {}).items():
            ent = led._tenant(name)
            ent["limit"] = dec(row["limit"])
            ent["reserved"] = float(row["reserved"])
            ent["reserved_n"] = int(row["reserved_n"])
            ent["spent"] = float(row["spent"])
            ent["requests"] = int(row["requests"])
            ent["rejected"] = int(row["rejected"])
            ent["downgraded"] = int(row["downgraded"])
            ent["rate_limited"] = int(row.get("rate_limited", 0))
            ent["rate_limit"] = dec(row.get("rate_limit"))
            ent["burst"] = dec(row.get("burst"))
            ent["tokens"] = ent["burst"]
            ent["stamp"] = None
            ent["resv"] = {
                int(rid): float(amt)
                for rid, amt in row.get("resv", {}).items()
            }
            by_arm = np.asarray(row.get("by_arm", []), np.float64)
            if by_arm.size:
                ent["by_arm"] = by_arm
        return led


@dataclasses.dataclass
class RequestResult:
    """Completion record delivered through a request's future."""

    prediction: int
    cost: float
    planned_cost: float
    cluster: int
    budget: float
    stop_wave: int                   # waves invoked before Prop. 4 stopped it
    mode: str                        # data plane that served it: jit | reference
    latency_s: float                 # completion time - arrival time
    request_id: int = -1             # feedback key for record_outcome()


class RequestFuture:
    """Single-request completion handle returned by :meth:`BatchScheduler.submit`.

    ``request_id`` is the scheduler-assigned key for asynchronous
    ground-truth feedback: once the future completes, the caller may report
    the true label via ``scheduler.record_outcome(fut.request_id, label)``.
    """

    __slots__ = ("_sched", "request", "request_id", "_result")

    def __init__(self, sched: "BatchScheduler", request: Request,
                 request_id: int = -1):
        self._sched = sched
        self.request = request
        self.request_id = request_id
        self._result: Optional[RequestResult] = None

    def done(self) -> bool:
        return self._result is not None

    def result(self, wait: bool = True) -> RequestResult:
        """The request's result; with ``wait`` (default) drives the
        scheduler until this request completes."""
        if self._result is None and wait:
            self._sched._force(self)
        if self._result is None:
            raise RuntimeError("request not completed; pump() or drain() first")
        return self._result

    # columnar fill interface shared with BlockFuture
    def _fill(self, pos, predictions, costs, planned, clusters, budgets,
              stop_waves, mode, latencies):
        self._result = RequestResult(
            prediction=int(predictions[0]),
            cost=float(costs[0]),
            planned_cost=float(planned[0]),
            cluster=int(clusters[0]),
            budget=float(budgets[0]),
            stop_wave=int(stop_waves[0]),
            mode=mode,
            latency_s=float(latencies[0]),
            request_id=self.request_id,
        )


class BlockFuture:
    """Columnar completion handle for a :meth:`BatchScheduler.submit_many`
    block: per-request results land in preallocated arrays as each budget
    group retires, with no per-request Python objects anywhere on the path.
    """

    __slots__ = (
        "_sched", "n", "_ndone", "predictions", "costs", "planned_costs",
        "clusters", "budgets", "stop_waves", "latencies_s", "modes",
        "request_ids",
    )

    def __init__(self, sched: "BatchScheduler", n: int,
                 request_ids: Optional[np.ndarray] = None):
        self._sched = sched
        self.n = n
        self._ndone = 0
        self.request_ids = (
            np.full(n, -1, np.int64) if request_ids is None else request_ids
        )
        self.predictions = np.full(n, -1, np.int64)
        self.costs = np.zeros(n, np.float64)
        self.planned_costs = np.zeros(n, np.float64)
        self.clusters = np.full(n, -1, np.int64)
        self.budgets = np.zeros(n, np.float64)
        self.stop_waves = np.zeros(n, np.int64)
        self.latencies_s = np.zeros(n, np.float64)
        self.modes = np.zeros(n, dtype="U9")

    def done(self) -> bool:
        return self._ndone >= self.n

    def result(self, wait: bool = True) -> "BlockFuture":
        if not self.done() and wait:
            self._sched._force(self)
        if not self.done():
            raise RuntimeError("block not completed; pump() or drain() first")
        return self

    def _fill(self, pos, predictions, costs, planned, clusters, budgets,
              stop_waves, mode, latencies):
        self.predictions[pos] = predictions
        self.costs[pos] = costs
        self.planned_costs[pos] = planned
        self.clusters[pos] = clusters
        self.budgets[pos] = budgets
        self.stop_waves[pos] = stop_waves
        self.modes[pos] = mode
        self.latencies_s[pos] = latencies
        self._ndone += len(pos)


class _Segment:
    """One enqueued block: columnar request arrays + the future they feed.

    ``submit`` makes 1-row segments around a RequestFuture; ``submit_many``
    makes one n-row segment around a BlockFuture. Admission slices segments
    off the queue head FIFO, splitting the last one if the batch fills
    mid-segment.
    """

    __slots__ = ("payloads", "emb", "budgets", "arrival", "slo",
                 "sink", "pos", "ids", "requests", "tenants")

    def __init__(self, payloads, emb, budgets, arrival, slo, sink, pos,
                 ids, requests=None, tenants=None):
        self.payloads = payloads      # (n, ...) array or list
        self.emb = emb                # (n, d)
        self.budgets = budgets        # (n,)
        self.arrival = arrival        # (n,)
        self.slo = slo                # (n,) with nan = no SLO
        self.sink = sink              # RequestFuture | BlockFuture
        self.pos = pos                # (n,) rows of `sink` these fill
        self.ids = ids                # (n,) scheduler-assigned request ids
        self.requests = requests      # Optional[List[Request]] (submit path)
        if tenants is None:
            tenants = np.full(self.budgets.shape[0], "default", object)
        self.tenants = tenants        # (n,) ledger principals

    def __len__(self) -> int:
        return self.budgets.shape[0]

    def split(self, k: int) -> "_Segment":
        """Pop the first ``k`` rows off as a new segment (FIFO admission)."""
        head = _Segment(
            self.payloads[:k], self.emb[:k], self.budgets[:k],
            self.arrival[:k], self.slo[:k], self.sink, self.pos[:k],
            self.ids[:k],
            self.requests[:k] if self.requests is not None else None,
            self.tenants[:k],
        )
        self.payloads = self.payloads[k:]
        self.emb = self.emb[k:]
        self.budgets = self.budgets[k:]
        self.arrival = self.arrival[k:]
        self.slo = self.slo[k:]
        self.pos = self.pos[k:]
        self.ids = self.ids[k:]
        if self.requests is not None:
            self.requests = self.requests[k:]
        self.tenants = self.tenants[k:]
        return head


class _Group:
    """One dispatched budget group riding in flight."""

    __slots__ = ("pending", "arrival", "part_sinks", "part_id", "part_pos",
                 "ids", "n", "requests", "tenants", "reserved")

    def __init__(self, pending, arrival, part_sinks, part_id, part_pos,
                 ids=None, requests=None, tenants=None, reserved=None):
        self.pending = pending        # router.PendingRoute
        self.arrival = arrival        # (n,)
        self.part_sinks = part_sinks  # list of futures contributing rows
        self.part_id = part_id        # (n,) index into part_sinks; None = one part
        self.part_pos = part_pos      # (n,) row of the sink each query fills
        self.ids = ids                # (n,) request ids (feedback key)
        self.n = arrival.shape[0]
        self.requests = requests
        self.tenants = tenants        # (n,) ledger principals; None = no ledger
        self.reserved = reserved      # (n,) admission reservations to settle


class BatchScheduler:
    """Continuous-batching front-end over a :class:`ThriftRouter`.

    Streaming use — submit anytime, drive with ``pump()`` (non-blocking
    progress) or ``drain()`` (run the backlog dry); hold futures::

        fut = sched.submit(Request(payload, emb, budget, slo_s=0.05))
        blk = sched.submit_many(payloads, embs, budget)   # columnar block
        sched.pump()          # admit/dispatch/retire whatever is due
        res = fut.result()    # drives the scheduler until this completes

    Batch-compat use (one-shot semantics, used by the equivalence tests)::

        sched.submit(...); ...
        for requests, route_result in sched.flush():
            ...

    Args:
      router: the ThriftRouter data plane.
      max_batch: admission batch size cap.
      max_wait_s: oldest-request wait that forces admission.
      max_inflight: budget groups allowed in flight at once (2 =
        double-buffered waves; 1 degenerates to a serial loop).
      speculation: ``"auto"`` (cost-aware switch), ``"jit"`` or
        ``"reference"`` to pin the data plane.
      speculation_threshold: USD per query the auto switch may gamble on
        speculatively invoked *metered* arms (see
        :meth:`ThriftRouter.speculation_cost`).
      slo_margin_s: dispatch headroom subtracted from a request's ``slo_s``
        when computing its admission deadline.
      prefetch_plans: build missing wave plans from the queued (cluster,
        budget) composition while waiting for the flush deadline.
      coalesce: saturation batch growth — when the backlog exceeds
        ``max_batch`` (arrivals outpacing service), one admission may take
        up to ``coalesce * max_batch`` requests, amortizing per-dispatch
        cost into bigger device batches exactly when latency is already
        queue-bound. 1 (default) keeps admissions at ``max_batch``; the
        legacy ``flush()`` API never coalesces.
      feedback: online estimation feedback from served traffic. ``True``
        builds a :class:`~repro_torch.serving.feedback.FeedbackLog` over the
        router's estimator; or pass a FeedbackLog instance (shareable
        across schedulers bound to the same estimator). ``None``/``False``
        (default) disables it — zero overhead. With
        feedback on, report ground truth via :meth:`record_outcome` /
        :meth:`record_outcomes`; pending labels fold into the estimator at
        the next admission boundary (never mid-wave).
      ledger: per-tenant cost accounting + hard budget enforcement.
        ``True`` builds a :class:`CostLedger` (unlimited tenants until
        ``set_limit``); or pass a configured CostLedger. With a ledger on,
        admission enforces tenant limits: a request whose budget does not
        fit the tenant's remaining headroom is *downgraded* to the largest
        affordable cheaper budget tier (``budget_tiers`` or the
        PlanService's observed budgets), or *rejected* outright — its
        future completes immediately with ``mode="rejected"``,
        ``prediction=-1`` and zero cost. ``None``/``False`` (default)
        disables all of it: zero overhead, prior behavior.
      budget_tiers: explicit downgrade ladder for ledger admission; when
        None the PlanService's observed budgets are used.
    """

    def __init__(
        self,
        router,
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
    ):
        if speculation not in ("auto", "jit", "reference"):
            raise ValueError(f"unknown speculation mode {speculation!r}")
        self.router = router
        if feedback is True:
            feedback = FeedbackLog(router.estimator)
        self.feedback: Optional[FeedbackLog] = feedback or None
        # fault evidence (timeouts/errors/degrades) folds through the same
        # versioned estimator path as labels, so the Wilson drift gate can
        # replan flaky arms away and probe traffic can readmit them
        self.degradation: Optional[DegradationTracker] = (
            DegradationTracker(self.feedback)
            if self.feedback is not None else None
        )
        if ledger is True:
            ledger = CostLedger(num_arms=len(router.engine.arms))
        self.ledger: Optional[CostLedger] = ledger or None
        self.budget_tiers = (
            None if budget_tiers is None
            else sorted(float(b) for b in budget_tiers)
        )
        self._next_id = 0
        self.max_batch = int(max_batch)
        self.coalesce = max(1, int(coalesce))
        self.max_wait_s = float(max_wait_s)
        self.max_inflight = max(1, int(max_inflight))
        self.speculation = speculation
        self.speculation_threshold = float(speculation_threshold)
        self.slo_margin_s = float(slo_margin_s)
        self.prefetch_plans = bool(prefetch_plans)
        self._queue: collections.deque = collections.deque()  # of _Segment
        self._qlen = 0
        self._queue_version = 0
        self._prefetched_version = -1
        self._inflight: collections.deque = collections.deque()  # of _Group
        self._latencies: List[np.ndarray] = []
        self._lat_window = 1 << 17        # newest samples kept for percentiles
        self._lat_buffered = 0
        self.mitigator = StragglerMitigator(num_workers=len(router.engine.arms))
        self.arm_query_totals = np.zeros(len(router.engine.arms), np.int64)
        self._stats: Dict[str, float] = {
            "batches": 0,        # budget groups routed
            "requests": 0,       # requests admitted into routed batches
            "flushes": 0,        # admission events
            "submitted": 0,
            "completed": 0,
            "spec_jit": 0,       # groups served by the speculative jit plane
            "spec_reference": 0, # groups served by the compacting plane
            "inflight_peak": 0,
        }
        self._sync_plan_stats()

    # ------------------------------------------------------------------
    # Plan service plumbing
    # ------------------------------------------------------------------
    @property
    def stats(self) -> Dict[str, float]:
        """Control-plane counters, with the router's PlanService hit/miss/
        invalidation counters mirrored in on read (so the hot retire path
        never rebuilds the dict)."""
        self._sync_plan_stats()
        return self._stats

    def _sync_plan_stats(self):
        """Mirror the router's PlanService counters into ``stats`` so the
        serving control plane sees plan-cache hit/miss/invalidation rates
        without reaching into router internals. With feedback enabled, the
        FeedbackLog's label/drift counters are mirrored too — together they
        are the hit/miss/replan/drift dashboard of the online loop."""
        plans = getattr(self.router, "plans", None)
        if plans is not None:
            self._stats.update(plans.stats())
        if self.feedback is not None:
            self._stats.update(self.feedback.stats())
        if self.degradation is not None:
            self._stats.update(self.degradation.stats())
        if self.ledger is not None:
            self._stats.update(self.ledger.stats())

    # ------------------------------------------------------------------
    # Online ground-truth feedback (see serving/feedback.py)
    # ------------------------------------------------------------------
    def record_outcome(self, request_id: int, label: int) -> bool:
        """Report the ground-truth label of a completed request (keyed by
        ``RequestFuture.request_id`` / ``BlockFuture.request_ids``). The
        label is buffered and folds into the estimator at the next
        admission boundary — routing in flight is never perturbed. Returns
        True if the id matched a watched outcome."""
        if self.feedback is None:
            raise RuntimeError(
                "feedback is disabled; construct BatchScheduler(..., feedback=True)"
            )
        return self.feedback.record(request_id, label)

    def record_outcomes(self, request_ids, labels) -> int:
        """Batch :meth:`record_outcome`; returns how many ids matched."""
        if self.feedback is None:
            raise RuntimeError(
                "feedback is disabled; construct BatchScheduler(..., feedback=True)"
            )
        return self.feedback.record_many(request_ids, labels)

    def apply_feedback(self) -> Optional[FeedbackReport]:
        """Fold any pending labels into the estimator now. Called
        automatically at every admission boundary; public so a quiescent
        server (no traffic arriving) can still absorb late labels.

        A fold that drifted any clusters is followed by ONE batched replan:
        every plan the fold invalidated — across all drifted clusters and
        budgets — re-selects through a single
        :meth:`~repro_torch.serving.plans.PlanService.replan_stale` dispatch, so
        a drift storm never serializes cold selections across the next
        batches."""
        # gate on has_pending, not the labeled count: degradation evidence
        # (attempts with zero labels) must still trigger a fold + replan
        if self.feedback is None or not self.feedback.has_pending:
            return None
        report = self.feedback.apply()
        if report.drifted:
            plans = getattr(self.router, "plans", None)
            if plans is not None:
                plans.replan_stale(report.drifted)
        self._sync_plan_stats()
        return report

    def prewarm(self, budgets: Optional[List[float]] = None) -> int:
        """Precompute wave plans ahead of traffic (delegates to the
        router's PlanService): with ``budgets``, plan every known cluster at
        each budget; without, re-plan the hottest observed pairs. Returns
        the number of plans built."""
        plans = getattr(self.router, "plans", None)
        if plans is None:
            return 0
        built = plans.prewarm(budgets=budgets)
        self._sync_plan_stats()
        return built

    def _prefetch(self):
        """Queue-composition plan prefetch: whenever the queued set has
        changed since the last look, hand its (embedding, budget) columns to
        the PlanService so missing plans are built before the flush."""
        if not self.prefetch_plans or not self._queue:
            return
        if self._queue_version == self._prefetched_version:
            return
        self._prefetched_version = self._queue_version
        plans = getattr(self.router, "plans", None)
        if plans is None:
            return
        emb = np.concatenate([s.emb for s in self._queue])
        budgets = np.concatenate([s.budgets for s in self._queue])
        plans.prefetch_for(emb, budgets)
        self._sync_plan_stats()

    # ------------------------------------------------------------------
    # Admission
    # ------------------------------------------------------------------
    def _alloc_ids(self, n: int) -> np.ndarray:
        """Fresh request ids. With feedback bound, the FeedbackLog is the
        id authority, so schedulers sharing one log never collide keys."""
        if self.feedback is not None:
            return self.feedback.next_ids(n)
        start = self._next_id
        self._next_id += n
        return np.arange(start, start + n, dtype=np.int64)

    def submit(self, req: Request) -> RequestFuture:
        """Enqueue one request; returns its completion future (which carries
        the ``request_id`` to feed :meth:`record_outcome` later)."""
        rid = int(self._alloc_ids(1)[0])
        fut = RequestFuture(self, req, request_id=rid)
        self._queue.append(_Segment(
            [req.payload],
            np.asarray(req.embedding, np.float64)[None, :],
            np.asarray([req.budget], np.float64),
            np.asarray([req.arrival_s], np.float64),
            np.asarray([np.nan if req.slo_s is None else req.slo_s]),
            fut, np.zeros(1, np.int64), np.asarray([rid], np.int64),
            requests=[req], tenants=np.asarray([req.tenant], object),
        ))
        self._qlen += 1
        self._queue_version += 1
        self._stats["submitted"] += 1
        return fut

    def submit_many(
        self,
        payloads,
        embeddings: np.ndarray,
        budgets,
        slo_s: Optional[float] = None,
        arrival_s=None,
        tenant="default",
    ) -> BlockFuture:
        """Columnar block submission: ``n`` requests enter as one segment of
        arrays and resolve into one :class:`BlockFuture` — the high-rate
        path (an arrival process delivers bursts, not single requests).
        ``tenant`` (scalar or per-row sequence) names the cost-ledger
        principal the block's spend is charged to."""
        emb = np.asarray(embeddings, np.float64)
        n = emb.shape[0]
        if n == 0:
            return BlockFuture(self, 0)   # already done; never enqueued
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
        self.submit_block(
            payloads, emb, budgets, arrival, slo, blk, np.arange(n), ids,
            tenants,
        )
        return blk

    def submit_block(self, payloads, emb, budgets, arrival, slo, sink, pos,
                     ids, tenants) -> None:
        """Enqueue pre-built columnar rows against an externally-owned sink
        (``sink``/``pos``): the admission seam a sharded front-end (see
        :class:`~repro_torch.serving.replica.ReplicaSet`) uses to scatter one
        caller-visible :class:`BlockFuture` across several schedulers.
        ``submit_many`` is this plus the array building."""
        n = budgets.shape[0]
        self._queue.append(_Segment(
            payloads, emb, budgets, arrival, slo, sink, pos, ids,
            tenants=tenants,
        ))
        self._qlen += n
        self._queue_version += 1
        self._stats["submitted"] += n

    def _seg_deadline(self, seg: _Segment) -> float:
        """Earliest time any request in the segment must be admitted:
        arrival + max_wait, tightened by per-request SLOs."""
        wait = np.minimum(
            self.max_wait_s,
            np.where(np.isnan(seg.slo), self.max_wait_s,
                     np.maximum(seg.slo - self.slo_margin_s, 0.0)),
        )
        return float((seg.arrival + wait).min())

    def next_deadline(self) -> Optional[float]:
        """Monotonic time the queue's most urgent request must flush by
        (None when idle) — lets an event loop sleep instead of polling."""
        if not self._queue:
            return None
        return min(self._seg_deadline(s) for s in self._queue)

    def ready(self) -> bool:
        """Is a batch due for admission? Full batch, oldest-request wait
        expiry, or an SLO deadline — whichever comes first."""
        if not self._queue:
            return False
        if self._qlen >= self.max_batch:
            return True
        return time.monotonic() >= self.next_deadline()

    def _take_batch(self, coalesce: bool = True) -> List[_Segment]:
        """Pop one admission off the queue head (FIFO), splitting the
        boundary segment if needed. Admissions are ``max_batch`` requests,
        except under saturation (backlog > ``max_batch``) where they may
        grow to ``coalesce * max_batch`` — latency is already queue-bound
        there, so bigger device batches are free throughput."""
        limit = self.max_batch
        if coalesce and self._qlen > limit:
            limit = min(self._qlen, self.coalesce * self.max_batch)
        take: List[_Segment] = []
        n = 0
        while self._queue and n < limit:
            seg = self._queue[0]
            room = limit - n
            if len(seg) <= room:
                take.append(self._queue.popleft())
            else:
                take.append(seg.split(room))
            n += len(take[-1])
        self._qlen -= n
        self._queue_version += 1
        return take

    @staticmethod
    def _cat_payloads(parts: Sequence[Any]):
        if len(parts) == 1:
            return parts[0]
        if all(isinstance(p, np.ndarray) for p in parts):
            return np.concatenate(parts)
        out: List[Any] = []
        for p in parts:
            out.extend(list(p))
        return out

    @staticmethod
    def _index_payloads(payloads, rows: np.ndarray):
        if isinstance(payloads, np.ndarray):
            return payloads[rows]
        return [payloads[i] for i in rows]

    # ------------------------------------------------------------------
    # Dispatch / retire: the pipelined data plane
    # ------------------------------------------------------------------
    def _route_mode(self) -> str:
        # "auto" defers to begin_route's switch (which also honors a router
        # pinned to the reference plane via jit_waves=False)
        return self.speculation

    @staticmethod
    def _stack_segments(take: List[_Segment]):
        """Columnar view of an admitted batch; the single-segment case (the
        block-submission hot path) is zero-copy."""
        if len(take) == 1:
            s = take[0]
            return (s.payloads, s.emb, s.budgets, s.arrival, [s.sink], None,
                    s.pos, s.ids, s.tenants)
        payloads = BatchScheduler._cat_payloads([s.payloads for s in take])
        emb = np.concatenate([s.emb for s in take])
        budgets = np.concatenate([s.budgets for s in take])
        arrival = np.concatenate([s.arrival for s in take])
        part_sinks = [s.sink for s in take]
        part_id = np.concatenate([
            np.full(len(s), i, np.int64) for i, s in enumerate(take)
        ])
        part_pos = np.concatenate([s.pos for s in take])
        ids = np.concatenate([s.ids for s in take])
        tenants = np.concatenate([s.tenants for s in take])
        return (payloads, emb, budgets, arrival, part_sinks, part_id,
                part_pos, ids, tenants)

    def _downgrade_budget(self, tenant: str, budget: float) -> Optional[float]:
        """Largest budget tier strictly cheaper than ``budget`` that still
        fits the tenant's remaining ledger headroom; None when none does.
        Tiers come from ``budget_tiers`` or, by default, the budgets the
        PlanService has already planned (so a downgraded request lands on a
        hot plan, not a cold compile)."""
        tiers = self.budget_tiers
        if tiers is None:
            plans = getattr(self.router, "plans", None)
            tiers = plans.known_budgets() if plans is not None else []
        remaining = self.ledger.remaining(tenant)
        best = None
        for b in tiers:
            if 0.0 < b < budget and b <= remaining:
                best = b if best is None else max(best, b)
        return best

    def _admit_ledger(self, budgets, tenants, arrival, part_sinks, part_id,
                      part_pos, ids=None):
        """Hard budget enforcement at the admission boundary.

        Sequentially (arrival order — admission must not depend on how rows
        later split into budget groups): first the tenant's QPS token
        bucket (a rate-limited request is rejected outright — no budget
        interaction, no downgrade), then reserves each request's budget
        against its tenant; on a miss, tries a downgrade to the largest
        affordable cheaper tier; otherwise rejects. Rejected rows complete
        immediately (``mode="rejected"``, prediction -1, zero cost) and are
        dropped from the batch. Returns ``(keep_rows, budgets, reserved)``
        with ``budgets`` a (possibly downgraded) copy."""
        n = budgets.shape[0]
        budgets = budgets.copy()   # single-segment stacking is zero-copy
        reserved = np.zeros(n, np.float64)
        keep = np.ones(n, bool)
        led = self.ledger
        for i in range(n):
            tenant = tenants[i]
            amount = float(budgets[i])
            rid = int(ids[i]) if ids is not None else None
            if not led.allow_request(tenant):
                keep[i] = False
                led.note_rate_limited(tenant)
                continue
            if led.try_reserve(tenant, amount, request_id=rid):
                reserved[i] = amount
                continue
            down = self._downgrade_budget(tenant, amount)
            if down is not None and led.try_reserve(tenant, down,
                                                    request_id=rid):
                budgets[i] = reserved[i] = down
                led.note_downgraded(tenant)
                continue
            keep[i] = False
            led.note_rejected(tenant)
        rejected = np.flatnonzero(~keep)
        if rejected.size:
            k = rejected.shape[0]
            shell = _Group(None, arrival, part_sinks, part_id, part_pos)
            self._resolve_rows(
                shell, rejected,
                np.full(k, -1, np.int64), np.zeros(k), np.zeros(k),
                np.full(k, -1, np.int64), budgets[rejected],
                np.zeros(k, np.int64), "rejected", time.monotonic(),
            )
        return np.flatnonzero(keep), budgets, reserved

    def _dispatch_batch(self):
        """Admit one batch and dispatch its budget groups into flight.

        Pending ground-truth feedback folds into the estimator *here* — the
        admission boundary — so every query of the batch routes against one
        consistent estimator version and a fold can never land mid-wave.
        With a cost ledger bound, this is also where tenant limits are
        enforced (reserve / downgrade / reject)."""
        self.apply_feedback()
        take = self._take_batch()
        if not take:
            return
        (payloads, emb, budgets, arrival, part_sinks, part_id, part_pos,
         ids, tenants) = self._stack_segments(take)
        self._stats["flushes"] += 1
        reserved = None
        if self.ledger is not None:
            admitted, budgets, reserved = self._admit_ledger(
                budgets, tenants, arrival, part_sinks, part_id, part_pos,
                ids=ids,
            )
            if admitted.size < budgets.shape[0]:
                if admitted.size == 0:
                    return
                payloads = self._index_payloads(payloads, admitted)
                emb, budgets = emb[admitted], budgets[admitted]
                arrival, part_pos = arrival[admitted], part_pos[admitted]
                ids, tenants = ids[admitted], tenants[admitted]
                reserved = reserved[admitted]
                if part_id is not None:
                    part_id = part_id[admitted]
        self._stats["requests"] += budgets.shape[0]
        mode = self._route_mode()
        if (budgets == budgets[0]).all():
            group_rows = [None]                    # whole batch, no split
        else:
            # one group per budget, first-occurrence order, FIFO inside
            _, first = np.unique(budgets, return_index=True)
            group_rows = [
                np.flatnonzero(budgets == budgets[i]) for i in np.sort(first)
            ]
        for rows in group_rows:
            if rows is None:
                g_payloads, g_emb, g_budgets = payloads, emb, budgets
                g_arrival, g_id, g_pos, g_ids = arrival, part_id, part_pos, ids
                g_tenants = tenants if self.ledger is not None else None
                g_reserved = reserved
            else:
                g_payloads = self._index_payloads(payloads, rows)
                g_emb, g_budgets = emb[rows], budgets[rows]
                g_arrival, g_pos, g_ids = arrival[rows], part_pos[rows], ids[rows]
                g_id = part_id[rows] if part_id is not None else None
                g_tenants = tenants[rows] if self.ledger is not None else None
                g_reserved = reserved[rows] if reserved is not None else None
            self._launch(
                g_payloads, g_emb, g_budgets, g_arrival, part_sinks, g_id,
                g_pos, g_ids, g_tenants, g_reserved, mode,
            )
        self._stats["inflight_peak"] = max(
            self._stats["inflight_peak"], len(self._inflight)
        )

    def _launch(self, payloads, emb, budgets, arrival, part_sinks, part_id,
                part_pos, ids, tenants, reserved, mode):
        """Dispatch one admitted budget group into flight. The dispatch
        seam: a replica worker overrides this to *stage* the group so a
        :class:`~repro_torch.serving.replica.ReplicaSet` can fuse same-budget
        groups from several replicas into one wave program."""
        pending = self.router.begin_route(
            payloads, emb, budgets, mode=mode,
            speculation_threshold=self.speculation_threshold,
        )
        self._stats["spec_" + pending.kind] += 1
        self._stats["batches"] += 1
        self._inflight.append(
            _Group(pending, arrival, part_sinks, part_id, part_pos,
                   ids=ids, tenants=tenants, reserved=reserved)
        )

    def _resolve_rows(self, group: _Group, rows: np.ndarray, predictions,
                      costs, planned, clusters, budgets, stop_waves, mode,
                      now: float):
        """Columnar completion: fill each contributing future's slice."""
        latencies = now - group.arrival[rows]
        self._latencies.append(latencies)
        self._lat_buffered += latencies.shape[0]
        if self._lat_buffered > 2 * self._lat_window:
            self._trim_latencies()
        self._stats["completed"] += rows.shape[0]
        if group.part_id is None:
            group.part_sinks[0]._fill(
                group.part_pos[rows], predictions, costs, planned, clusters,
                budgets, stop_waves, mode, latencies,
            )
            return
        gid = group.part_id[rows]
        for pid in np.unique(gid):
            sel = gid == pid
            group.part_sinks[pid]._fill(
                group.part_pos[rows[sel]], predictions[sel], costs[sel],
                planned[sel], clusters[sel], budgets[sel], stop_waves[sel],
                mode, latencies[sel],
            )

    def _retire(self, group: _Group) -> int:
        """Complete one in-flight group: step reference-mode groups wave by
        wave (futures fire at each query's stop wave), block on jit-mode
        device results, then account latencies and plan stats."""
        pending = group.pending
        if pending.kind == "reference" and pending.rng is None:
            all_rows = np.arange(group.n)
            resolved = np.zeros(group.n, bool)
            while not pending.exhausted:
                wave = pending._t
                rows, preds = pending.step()
                if rows.size:
                    self._resolve_rows(
                        group, rows, preds, pending.costs[rows],
                        pending.planned[rows], pending.cluster_ids[rows],
                        pending.budgets[rows],
                        np.full(rows.shape[0], min(wave, pending.T), np.int64),
                        "reference", time.monotonic(),
                    )
                    resolved[rows] = True
            res = pending.result()
            left = all_rows[~resolved]
            if left.size:   # defensive: every row should resolve via steps
                self._resolve_rows(
                    group, left, res.predictions[left], res.costs[left],
                    res.planned_costs[left], res.clusters[left],
                    res.budgets[left], res.stop_waves[left],
                    "reference", time.monotonic(),
                )
        else:
            res = pending.result()
            self._resolve_rows(
                group, np.arange(group.n), res.predictions, res.costs,
                res.planned_costs, res.clusters, res.budgets,
                res.stop_waves, pending.kind, time.monotonic(),
            )
        self._account(res, group)
        return group.n

    def _account(self, res, group: Optional[_Group] = None):
        lat = [
            arm.latency_s(int(n)) if n else 0.0
            for arm, n in zip(self.router.engine.arms, res.arm_query_counts)
        ]
        self.mitigator.record_step(lat)
        self.arm_query_totals += np.asarray(res.arm_query_counts, np.int64)
        if self.feedback is not None and group is not None and group.ids is not None:
            # register the group's outcomes so later ground-truth labels can
            # be matched to (cluster, invoked arms, responses) by request id
            fb = self.feedback
            probes = None
            if fb.probe_rate > 0.0 and group.n:
                # exploration side channel: invoke one unplanned arm for a
                # thinned subset of rows — never touches predictions/costs,
                # only the feedback block a later label scores
                rows = fb.probe_rows(group.n)
                if rows.size:
                    arms = fb.probe_arms(res.clusters[rows], res.schedule[rows])
                    ok = arms >= 0
                    rows, arms = rows[ok], arms[ok]
                degrade = None
                policy = getattr(self.router.engine, "fault_policy", None)
                if rows.size and policy is not None and policy.active:
                    # probes hit the same faulty arms: draw their fate
                    # *before* invoking, drop failed probes (recording the
                    # failure as degradation evidence), corrupt degraded ones
                    codes = policy.row_codes(arms, rows)
                    failed = (codes == FAULT_TIMEOUT) | (codes == FAULT_ERROR)
                    if failed.any():
                        if self.degradation is not None:
                            self.degradation.record_failures(
                                res.clusters[rows[failed]], arms[failed]
                            )
                        rows, arms = rows[~failed], arms[~failed]
                        codes = codes[~failed]
                    degrade = codes == FAULT_DEGRADE if rows.size else None
                if rows.size:
                    resp = self.router.engine.invoke_rows(
                        arms, group.pending.payloads, rows
                    )
                    if degrade is not None and degrade.any():
                        resp = np.where(
                            degrade, policy.corrupt_rows(arms, rows), resp
                        )
                    probes = (rows, arms, resp)
            fb.observe(
                group.ids, res.clusters, res.schedule, res.responses,
                res.invoked, probes=probes,
            )
            if (self.degradation is not None
                    and getattr(res, "fault_codes", None) is not None):
                self.degradation.record_route(
                    res.clusters, res.fault_schedule, res.fault_codes
                )
        if (self.ledger is not None and group is not None
                and group.tenants is not None):
            self._settle(res, group)
        self._sync_plan_stats()

    def _settle(self, res, group: _Group):
        """Retire-time ledger settlement: release each tenant's admission
        reservations, commit the realized charge with its exact per-arm
        attribution (the effective post-failover schedule — re-routed waves
        charge the arm actually invoked)."""
        costs = self.router.engine.costs
        tenants = group.tenants
        for tenant in set(tenants.tolist()):
            sel = tenants == tenant
            rows = np.flatnonzero(sel)
            arms = res.schedule[rows][res.invoked[rows]]
            arm_spend = np.bincount(arms, minlength=costs.size) * costs
            self.ledger.settle(
                tenant,
                reserved=float(group.reserved[sel].sum()),
                charged=float(res.costs[sel].sum()),
                arm_spend=arm_spend,
                requests=int(rows.size),
                request_ids=group.ids[rows] if group.ids is not None else None,
            )

    def reconcile_ledger(self) -> int:
        """Release ledger reservations no live request backs.

        The restart handshake: after ``CostLedger.restore()`` the dead
        process's admission reservations are still held (conservatively —
        the invariant ``spent + reserved <= limit`` must survive the
        handoff). A scheduler bound to the restored ledger calls this once
        to reconcile: every id-tracked reservation not matching a request
        this scheduler actually holds (queued or in flight) is released
        exactly. Returns the number of reservations released; 0 without a
        ledger."""
        if self.ledger is None:
            return 0
        live: List[int] = []
        for seg in self._queue:
            if seg.ids is not None:
                live.extend(np.asarray(seg.ids, np.int64).ravel().tolist())
        for group in self._inflight:
            if group.ids is not None:
                live.extend(np.asarray(group.ids, np.int64).ravel().tolist())
        return self.ledger.release_orphans(live)

    # ------------------------------------------------------------------
    # Driving
    # ------------------------------------------------------------------
    def pump(self) -> int:
        """Make progress without avoidable blocking; returns requests
        completed during the call. Retires every group whose device work
        already finished, admits/dispatches batches that are due (blocking
        on the oldest group only when the pipeline is full), and spends
        idle queue time prefetching plans for the queued composition."""
        done = 0
        while True:
            while self._inflight and self._inflight[0].pending.ready():
                done += self._retire(self._inflight.popleft())
            if self.ready():
                if len(self._inflight) >= self.max_inflight:
                    done += self._retire(self._inflight.popleft())
                self._dispatch_batch()
                continue
            break
        if self._queue:
            self._prefetch()
        return done

    def drain(self) -> int:
        """Run the backlog dry: admit everything queued (ignoring
        deadlines), keep ``max_inflight`` groups in flight, retire all.
        Returns requests completed."""
        done = 0
        while self._queue or self._inflight:
            while self._queue and len(self._inflight) < self.max_inflight:
                self._dispatch_batch()
            if self._inflight:   # a fully-rejected admission leaves nothing
                done += self._retire(self._inflight.popleft())
        return done

    def _force(self, fut) -> None:
        """Drive until ``fut`` completes (future.result() entry point)."""
        while not fut.done() and self._inflight:
            self._retire(self._inflight.popleft())
        if not fut.done():
            self.drain()

    # ------------------------------------------------------------------
    # Latency accounting
    # ------------------------------------------------------------------
    def _trim_latencies(self):
        """Keep only the newest ``_lat_window`` samples, so a long-running
        server's latency history stays bounded (the percentile summary is a
        sliding window, like the StragglerMitigator's)."""
        lat = np.concatenate(self._latencies)[-self._lat_window:]
        self._latencies = [lat]
        self._lat_buffered = lat.shape[0]

    def latency_stats(self) -> Dict[str, float]:
        """Completion-latency summary: ``count`` covers everything ever
        completed; the percentiles cover the newest ``_lat_window``
        (default 128k) samples."""
        if not self._latencies:
            return {"count": 0}
        self._trim_latencies()
        lat = self._latencies[0]
        return {
            "count": int(self._stats["completed"]),
            "p50_s": float(np.percentile(lat, 50)),
            "p99_s": float(np.percentile(lat, 99)),
            "mean_s": float(lat.mean()),
            "max_s": float(lat.max()),
        }

    # ------------------------------------------------------------------
    # One-shot API (kept for batch callers and the equivalence tests)
    # ------------------------------------------------------------------
    def flush(self) -> List[Tuple[List[Request], Any]]:
        """Admit one batch and route it synchronously as a single
        heterogeneous-budget call; returns ``[(requests, RouteResult)]``.

        Accounting: ``stats["batches"]`` counts the budget
        groups actually routed and the StragglerMitigator only sees the
        latency of arms the wavefront really invoked. Futures of the
        flushed requests complete before this returns.
        """
        self.apply_feedback()
        take = self._take_batch(coalesce=False)
        if not take:
            return []
        (payloads, emb, budgets, arrival, part_sinks, part_id, part_pos,
         ids, tenants) = self._stack_segments(take)
        self._stats["flushes"] += 1
        reserved = None
        if self.ledger is not None:
            admitted, budgets, reserved = self._admit_ledger(
                budgets, tenants, arrival, part_sinks, part_id, part_pos,
                ids=ids,
            )
            if admitted.size < budgets.shape[0]:
                if admitted.size == 0:
                    return []
                payloads = self._index_payloads(payloads, admitted)
                emb, budgets = emb[admitted], budgets[admitted]
                arrival, part_pos = arrival[admitted], part_pos[admitted]
                ids, tenants = ids[admitted], tenants[admitted]
                reserved = reserved[admitted]
                if part_id is not None:
                    part_id = part_id[admitted]
        pending = self.router.begin_route(
            payloads, emb, budgets, mode=self._route_mode(),
            speculation_threshold=self.speculation_threshold,
        )
        res = pending.result()
        self._stats["spec_" + pending.kind] += 1
        self._stats["batches"] += len(np.unique(budgets))
        self._stats["requests"] += budgets.shape[0]
        group = _Group(
            pending, arrival, part_sinks, part_id, part_pos, ids=ids,
            tenants=tenants if self.ledger is not None else None,
            reserved=reserved,
        )
        self._resolve_rows(
            group, np.arange(group.n), res.predictions, res.costs,
            res.planned_costs, res.clusters, res.budgets, res.stop_waves,
            pending.kind, time.monotonic(),
        )
        self._account(res, group)
        requests: List[Request] = []
        for s in take:
            if s.requests is not None:
                requests.extend(s.requests)
            else:
                requests.extend(
                    Request(p, e, float(b), arrival_s=float(a))
                    for p, e, b, a in zip(s.payloads, s.emb, s.budgets, s.arrival)
                )
        if self.ledger is not None and len(requests) != budgets.shape[0]:
            requests = [requests[i] for i in admitted]   # drop rejected rows
        return [(requests, res)]
