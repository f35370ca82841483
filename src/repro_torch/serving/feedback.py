"""Online estimation feedback from served traffic (host numpy; the PyTorch
port's copy of ``repro/serving/feedback.py``).

The paper estimates per-(cluster, arm) success probabilities once, offline
(Sec. 3.1). In production the estimates drift — FrugalGPT and MetaLLM (see
PAPERS.md) both show router quality degrading as per-model accuracy moves
and recovering under online reward feedback. This module closes that loop
for the serving stack:

* **FeedbackLog.observe** — the scheduler registers every served request at
  completion, keyed by request id: its cluster plus the (arm, response)
  pairs of the waves that actually ran. Predictions come for free from the
  request futures; ground truth arrives later, asynchronously.
* **record / record_many** — a ground-truth label arrives for a request id.
  The label is matched against the stored responses, giving one per-arm
  correctness row for *invoked* arms only, which accumulates into
  per-(cluster, arm) success/attempt count buffers. Nothing touches the
  estimator yet — labels can arrive mid-wave without perturbing routing.
* **apply** — called by the scheduler at admission boundaries (never
  mid-wave): buffered counts fold into the estimator as one vectorized
  :meth:`~repro_torch.core.estimation.SuccessProbEstimator.update_counts` call
  per touched cluster, bumping the strictly monotone estimator ``version``.

**Drift gating.** A fold only invalidates a cluster's cached plans when the
estimate *actually moved*: the candidate post-fold estimate is compared
per-arm against the plan-visible snapshot (the estimate the current plans
were built from) with a Wilson interval-overlap test (reusing
:func:`~repro_torch.core.estimation.wilson_interval`). Disjoint intervals on any
observed arm ⇒ drift ⇒ the fold is plan-visible (the cluster's plan
``version`` bumps and the PlanService's version-keyed caches miss lazily).
Overlapping intervals ⇒ confirming feedback ⇒ the fold still tightens the
estimate but the plan version stays put, so hot-path plan cache hits
survive.

**Exploration probes.** Once a plan stops invoking an arm, served traffic
yields no more feedback for it, so a *recovered* arm would never re-enter
the estimates. ``FeedbackLog(probe_rate=r)`` closes that loop minimally:
the scheduler marks ~``r`` of feedback-eligible requests and invokes ONE
currently-unplanned arm (the least-observed one for the request's cluster)
as a side channel — the probe response never touches routing or the
request's prediction, but when the ground-truth label arrives it feeds the
probed arm's (cluster, arm) counts exactly like a planned wave, so a
recovered arm's estimate climbs until the drift test re-selects it. Off by
default (``probe_rate=0``), in which case the zero-label path stays
bit-identical to feedback without probing.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.estimation import (
    SuccessProbEstimator,
    fold_counts,
    wilson_interval,
)
from repro_torch.distributed.fault import FAULT_DEGRADE, FAULT_ERROR, FAULT_TIMEOUT


@dataclasses.dataclass
class FeedbackReport:
    """What one admission-boundary :meth:`FeedbackLog.apply` folded in."""

    labels: int = 0                     # labeled requests folded
    clusters: Tuple[int, ...] = ()      # clusters that received feedback
    drifted: Tuple[int, ...] = ()       # subset whose plans invalidated
    version: int = 0                    # estimator version after the fold


@dataclasses.dataclass
class FeedbackShard:
    """A replica-local slice of buffered feedback counts.

    The shard is exactly the :class:`FeedbackLog` pending-buffer shape —
    ``cluster -> [successes (L,), attempts (L,), labeled queries]`` plus the
    total labeled-request count — detached from any log. Because every
    entry is a pure monotone sum of unit increments (integer-valued
    floats, exact far below 2**53), shards merge by plain addition:
    :func:`merge_counts` is associative and commutative bit-for-bit, and
    *any* partition of a label stream across R shards folds back to the
    single-log totals. That is the whole multi-replica feedback contract —
    replicas fold locally, the control plane adds shards at admission
    boundaries, and one central :meth:`FeedbackLog.apply` reproduces the
    single-log estimator state and replan set exactly.
    """

    counts: Dict[int, List]             # cid -> [succ (L,), att (L,), nq]
    labels: int = 0                     # labeled requests in the shard

    @property
    def empty(self) -> bool:
        return not self.counts

    def copy(self) -> "FeedbackShard":
        return FeedbackShard(
            {cid: [b[0].copy(), b[1].copy(), b[2]]
             for cid, b in self.counts.items()},
            self.labels,
        )


def merge_counts(*shards: FeedbackShard) -> FeedbackShard:
    """Add feedback shards: elementwise (success, attempt, query) sums per
    cluster. Exact — counts are integer-valued — hence associative,
    commutative and partition-invariant (the property suite in
    ``tests/test_torch_feedback.py`` pins them on the port)."""
    out: Dict[int, List] = {}
    labels = 0
    for shard in shards:
        labels += shard.labels
        for cid, (succ, att, nq) in shard.counts.items():
            buf = out.get(cid)
            if buf is None:
                out[cid] = [succ.copy(), att.copy(), int(nq)]
            else:
                buf[0] += succ
                buf[1] += att
                buf[2] += int(nq)
    return FeedbackShard(out, labels)


class FeedbackLog:
    """Asynchronous ground-truth feedback, keyed by request id.

    Owned by a :class:`~repro_torch.serving.scheduler.BatchScheduler` (pass
    ``feedback=True``) or constructed standalone and shared across
    schedulers bound to the same estimator.

    Args:
      estimator: the :class:`SuccessProbEstimator` to stream feedback into.
      delta: interval failure target for the refreshed Hoeffding CIs.
      drift_delta: failure target of the Wilson intervals in the drift
        test — smaller widens the intervals, making the detector *less*
        trigger-happy (more feedback needed before plans re-select).
      max_watch: outcome-retention window: only the newest ``max_watch``
        observed requests are retained — older unlabeled outcomes are
        evicted, and already-labeled ids age out of the bookkeeping too,
        so memory stays bounded whether or not labels ever arrive.
      probe_rate: exploration probability — the fraction of
        feedback-eligible requests for which the scheduler additionally
        invokes one currently-unplanned arm so recovered arms can re-enter
        the estimates. 0 (default) disables probing entirely (no rng is
        consumed; the zero-label path is bit-identical).
      probe_seed: seed of the probe-thinning rng.

    A :class:`DegradationTracker` may additionally stream *failure*
    evidence (timeouts/errors — attempts that can never be correct) into
    the same pending buffers, so flaky arms ride the identical
    fold → Wilson-gate → replan path that label feedback does.
    """

    def __init__(
        self,
        estimator: SuccessProbEstimator,
        delta: float = 0.01,
        drift_delta: float = 0.05,
        max_watch: int = 1 << 20,
        probe_rate: float = 0.0,
        probe_seed: int = 0,
    ):
        self.estimator = estimator
        self.delta = float(delta)
        self.drift_delta = float(drift_delta)
        self.max_watch = int(max_watch)
        self.probe_rate = float(probe_rate)
        self.probe_seed = int(probe_seed)
        self._probe_rng = np.random.default_rng(probe_seed)
        self.probes = 0          # exploration invocations registered
        # request-id authority: schedulers bound to this log draw ids here,
        # so sharing one log across schedulers can never collide keys
        self._next_id = 0
        # request id -> (block id, row); blocks hold whole retired-group
        # matrices (columnar, no per-request slicing on the retire path)
        self._watch: Dict[int, Tuple[int, int]] = {}
        self._watch_order: Deque[int] = collections.deque()
        # block id -> [clusters (B,), schedule (B,T), responses (B,T),
        #              invoked (B,T), live row refcount]
        self._blocks: Dict[int, List] = {}
        self._next_block = 0
        # cluster -> [successes (L,), attempts (L,), labeled queries]
        self._pending: Dict[int, List] = {}
        self._pending_labels = 0
        self.labels = 0          # labels matched to a watched request
        self.unmatched = 0       # labels for unknown/evicted/duplicate ids
        self.evicted = 0         # watched outcomes dropped by max_watch
        self.applies = 0         # admission-boundary folds that did work
        self.drifts = 0          # cluster-folds that invalidated plans

    def next_ids(self, n: int) -> np.ndarray:
        """Reserve ``n`` fresh request ids. The log is the id authority so
        that multiple schedulers sharing it stay collision-free."""
        start = self._next_id
        self._next_id += int(n)
        return np.arange(start, start + n, dtype=np.int64)

    # ------------------------------------------------------------------
    # Serving-side registration
    # ------------------------------------------------------------------
    def probe_rows(self, n: int) -> np.ndarray:
        """Thin a retired group of ``n`` requests down to the rows to probe.
        With ``probe_rate == 0`` returns empty without consuming the rng."""
        if self.probe_rate <= 0.0 or n == 0:
            return np.zeros(0, np.int64)
        return np.flatnonzero(self._probe_rng.random(n) < self.probe_rate)

    def probe_arms(self, clusters: np.ndarray, schedule: np.ndarray) -> np.ndarray:
        """Pick the exploration arm per probed request: the least-observed
        arm the request's plan did NOT schedule (ties to the lowest index;
        -1 when the plan already covers the whole pool). Least-observed
        targets exactly the arms whose estimates have gone blind — the
        recovered-arm case the ROADMAP left open."""
        L = self.estimator.num_arms
        out = np.full(len(clusters), -1, np.int64)
        for i, (cid, sched) in enumerate(zip(clusters, schedule)):
            planned = np.zeros(L, bool)
            planned[sched[sched >= 0]] = True
            cand = np.flatnonzero(~planned)
            if cand.size == 0:
                continue
            counts = self.estimator.clusters[int(cid)].arm_counts
            out[i] = int(cand[np.argmin(counts[cand])])
        return out

    def observe(
        self,
        ids: np.ndarray,            # (B,) request ids
        clusters: np.ndarray,       # (B,)
        schedule: np.ndarray,       # (B, T) arm id per wave, -1 = none
        responses: np.ndarray,      # (B, T) class id per wave, -1 = not run
        invoked: np.ndarray,        # (B, T) wave actually ran
        probes=None,                # optional (rows, arms, responses)
    ) -> None:
        """Register a retired group's outcomes to await ground truth.

        Columnar: the group's (schedule, responses, invoked) matrices are
        stored whole (one block, no per-request slicing on the retire
        path); a request's invoked-arm rows are extracted lazily when its
        label arrives — feedback stays masked to invoked arms, matching
        what a real deployment can observe. Never touches the estimator or
        any rng, so enabling feedback with zero labels is
        routing-identical to feedback disabled.

        ``probes`` carries the scheduler's exploration side channel: the
        probed rows' extra (arm, response) pairs land as one appended wave
        column, so a later label scores the probed arm exactly like a
        planned wave.
        """
        ids = np.asarray(ids, np.int64)
        if ids.size == 0:
            return
        if probes is not None:
            rows, arms, resp = probes
            rows = np.asarray(rows, np.int64)
            if rows.size:
                B = schedule.shape[0]
                schedule = np.concatenate(
                    [schedule, np.full((B, 1), -1, schedule.dtype)], axis=1
                )
                responses = np.concatenate(
                    [responses, np.full((B, 1), -1, responses.dtype)], axis=1
                )
                invoked = np.concatenate(
                    [invoked, np.zeros((B, 1), bool)], axis=1
                )
                schedule[rows, -1] = np.asarray(arms, np.int64)
                responses[rows, -1] = np.asarray(resp, np.int64)
                invoked[rows, -1] = True
                self.probes += int(rows.size)
        bid = self._next_block
        self._next_block += 1
        self._blocks[bid] = [
            np.asarray(clusters, np.int64), schedule, responses, invoked,
            int(ids.size),
        ]
        watch, order = self._watch, self._watch_order
        for i, rid in enumerate(ids.tolist()):
            watch[rid] = (bid, i)
            order.append(rid)
        # retention: the deque (not the dict) is the bounded object, so
        # ids whose labels already arrived are trimmed too — a healthily
        # labeled long-running server can't leak bookkeeping
        while len(order) > self.max_watch:
            self._evict(order.popleft())

    def _evict(self, rid: int) -> None:
        ent = self._watch.pop(rid, None)
        if ent is not None:
            self.evicted += 1
            self._release_block(ent[0])

    def _release_block(self, bid: int, rows: int = 1) -> None:
        blk = self._blocks[bid]
        blk[4] -= rows
        if blk[4] == 0:          # last live row gone: free the matrices
            del self._blocks[bid]

    @property
    def watching(self) -> int:
        """Completed requests currently awaiting a label."""
        return len(self._watch)

    @property
    def pending(self) -> int:
        """Labeled requests buffered for the next admission-boundary fold."""
        return self._pending_labels

    @property
    def has_pending(self) -> bool:
        """Anything buffered for the next fold — labeled requests *or*
        failure evidence from a :class:`DegradationTracker` (which carries
        attempts but no labels)."""
        return bool(self._pending)

    # ------------------------------------------------------------------
    # Label arrival
    # ------------------------------------------------------------------
    def record(self, request_id: int, label: int) -> bool:
        """Ground truth arrived for a served request; returns True if the
        id matched a watched outcome. Buffers per-(cluster, arm) counts;
        the estimator is only touched at the next :meth:`apply`."""
        return self.record_many([request_id], [label]) == 1

    def _buf(self, cid: int) -> List:
        buf = self._pending.get(cid)
        if buf is None:
            L = self.estimator.num_arms
            buf = self._pending[cid] = [
                np.zeros(L, np.float64), np.zeros(L, np.float64), 0,
            ]
        return buf

    def record_many(self, request_ids, labels) -> int:
        """Batch label ingestion; returns how many ids matched.

        Columnar like the rest of the serving stack: ids resolve to
        (block, row) via one dict pop each, then every block's matched
        rows accumulate into the per-(cluster, arm) buffers with a few
        scatter-adds — no per-request numpy work."""
        ids = np.asarray(request_ids, np.int64).ravel()
        labs = np.asarray(labels, np.int64).ravel()
        by_block: Dict[int, Tuple[List[int], List[int]]] = {}
        matched = 0
        for rid, lab in zip(ids.tolist(), labs.tolist()):
            ent = self._watch.pop(rid, None)
            if ent is None:
                self.unmatched += 1
                continue
            matched += 1
            rows, row_labs = by_block.setdefault(ent[0], ([], []))
            rows.append(ent[1])
            row_labs.append(lab)
        for bid, (rows, row_labs) in by_block.items():
            clusters, schedule, responses, invoked, _ = self._blocks[bid]
            rows = np.asarray(rows, np.int64)
            row_labs = np.asarray(row_labs, np.int64)
            mask = invoked[rows]                                  # (k, T)
            correct = (responses[rows] == row_labs[:, None]) & mask
            cl = clusters[rows]
            for cid in np.unique(cl):
                sel = cl == cid
                m = mask[sel]
                arms = schedule[rows[sel]][m]
                buf = self._buf(int(cid))
                # arms repeat across requests: scatter-add, not fancy +=
                np.add.at(buf[0], arms, correct[sel][m].astype(np.float64))
                np.add.at(buf[1], arms, 1.0)
                buf[2] += int(sel.sum())
            self._release_block(bid, rows.size)
        self._pending_labels += matched
        self.labels += matched
        return matched

    # ------------------------------------------------------------------
    # Cross-replica shard plumbing (for a multi-replica front end)
    # ------------------------------------------------------------------
    def export_shard(self) -> FeedbackShard:
        """Drain the pending buffers into a detached :class:`FeedbackShard`.

        A replica-local log calls this at admission boundaries so the
        control plane can :func:`merge_counts` every replica's evidence and
        fold it through ONE central :meth:`apply`. The buffers leave empty
        (the counts now live in the shard)."""
        shard = FeedbackShard(self._pending, self._pending_labels)
        self._pending = {}
        self._pending_labels = 0
        return shard

    def absorb_shard(self, shard: FeedbackShard) -> None:
        """Add a (merged) shard's counts into this log's pending buffers —
        the inverse of :meth:`export_shard`. The next :meth:`apply` folds
        them exactly as if the labels had been recorded here."""
        for cid, (succ, att, nq) in shard.counts.items():
            buf = self._buf(int(cid))
            buf[0] += succ
            buf[1] += att
            buf[2] += int(nq)
        self._pending_labels += int(shard.labels)

    # ------------------------------------------------------------------
    # Admission-boundary fold
    # ------------------------------------------------------------------
    def _moved(self, st, cand_p: np.ndarray, cand_counts: np.ndarray,
               observed: np.ndarray) -> bool:
        """Interval-overlap drift test: did the estimate actually move?

        Compares the candidate post-fold estimate against the *plan-visible
        snapshot* (what the cached plans were built from), per arm, at each
        side's own counts. Disjoint Wilson intervals on any arm the feedback
        observed ⇒ drift. Comparing against the snapshot (not the previous
        fold) means slow drift still accumulates to a detection instead of
        hiding inside per-batch noise.
        """
        lo_old, hi_old = wilson_interval(
            st.plan_p_hat, st.plan_arm_counts, self.drift_delta
        )
        lo_new, hi_new = wilson_interval(cand_p, cand_counts, self.drift_delta)
        disjoint = (lo_new > hi_old) | (hi_new < lo_old)
        return bool((disjoint & observed).any())

    def apply(self) -> FeedbackReport:
        """Fold buffered feedback into the estimator — one vectorized
        ``update_counts`` per touched cluster, drift-gated plan visibility.

        Called by the scheduler at admission boundaries (never mid-wave),
        so every query of a batch routes against one consistent estimator
        version. A no-op (empty report) when nothing is buffered.
        """
        if not self._pending:
            return FeedbackReport(version=self.estimator.version)
        est = self.estimator
        touched, drifted = [], []
        labels = self._pending_labels
        for cid in sorted(self._pending):
            succ, att, nq = self._pending[cid]
            st = est.clusters[cid]
            observed = att > 0
            # the exact fold update_counts will commit, pre-computed (via
            # the shared fold_counts) so the drift decision sees it first
            cand_p, cand_counts = fold_counts(st.p_hat, st.arm_counts, succ, att)
            moved = self._moved(st, cand_p, cand_counts, observed)
            est.update_counts(
                cid, succ, att, queries=nq, delta=self.delta,
                plan_visible=moved,
            )
            touched.append(cid)
            if moved:
                drifted.append(cid)
        self._pending.clear()
        self._pending_labels = 0
        self.applies += 1
        self.drifts += len(drifted)
        return FeedbackReport(
            labels=labels,
            clusters=tuple(touched),
            drifted=tuple(drifted),
            version=est.version,
        )

    # ------------------------------------------------------------------
    def stats(self) -> Dict[str, int]:
        """Feedback counters (mirrored into ``BatchScheduler.stats``)."""
        return {
            "feedback_labels": self.labels,
            "feedback_unmatched": self.unmatched,
            "feedback_pending": self._pending_labels,
            "feedback_watching": len(self._watch),
            "feedback_evicted": self.evicted,
            "feedback_applies": self.applies,
            "feedback_drifts": self.drifts,
            "feedback_probes": self.probes,
        }


class DegradationTracker:
    """Folds arm failure outcomes into the online estimator path.

    Timeouts and errors are invisible to the label path — a failed
    invocation yields no response to score when ground truth arrives — so a
    persistently failing arm would keep its (stale, healthy) estimate and
    keep being planned. This tracker turns each *attempted* failure from a
    :class:`~repro_torch.serving.router.RouteResult`'s fault evidence into a
    per-(cluster, arm) zero-success attempt in the owning
    :class:`FeedbackLog`'s pending buffers. From there the evidence rides
    the existing machinery unchanged: the admission-boundary fold, the
    Wilson interval-overlap drift gate, versioned lazy plan invalidation
    and the batched replan — a flaky arm's success estimate collapses, the
    gate fires for exactly the clusters that observed the failures, plans
    route around it, and ``FeedbackLog`` probes readmit it once it
    recovers.

    Silent degradation needs no extra plumbing here: a degraded arm *does*
    answer (with a corrupted class), so its responses flow through
    ``observe``/``record_many`` and arriving labels mark them wrong — the
    same drift gate fires on the label evidence. The tracker only counts
    degraded cells for observability.
    """

    def __init__(self, feedback: FeedbackLog):
        self.feedback = feedback
        L = feedback.estimator.num_arms
        self.failures = 0        # attempted timeout/error invocations folded
        self.degraded = 0        # silently-degraded responses served
        self.routes = 0          # fault-bearing RouteResults ingested
        self.arm_failures = np.zeros(L, np.int64)

    def record_route(self, clusters: np.ndarray, fault_schedule: np.ndarray,
                     fault_codes: np.ndarray) -> int:
        """Ingest one RouteResult's fault evidence ((B, T) matrices over the
        *original* plan positions). Returns the failures folded."""
        if fault_codes is None:
            return 0
        failed = (fault_codes == FAULT_TIMEOUT) | (fault_codes == FAULT_ERROR)
        ndeg = int((fault_codes == FAULT_DEGRADE).sum())
        self.degraded += ndeg
        nf = int(failed.sum())
        if nf or ndeg:
            self.routes += 1
        if nf == 0:
            return 0
        hit_rows = failed.any(axis=1)
        cl = np.asarray(clusters, np.int64)
        for cid in np.unique(cl[hit_rows]):
            sel = cl == cid
            arms = fault_schedule[sel][failed[sel]]
            # attempts with zero successes; buf[2] (labeled-query count)
            # stays put — failures are not labels
            np.add.at(self.feedback._buf(int(cid))[1], arms, 1.0)
        self.arm_failures += np.bincount(
            fault_schedule[failed], minlength=self.arm_failures.size
        )
        self.failures += nf
        return nf

    def record_failures(self, clusters: np.ndarray, arms: np.ndarray) -> int:
        """Ingest flat (cluster, arm) failure pairs — the probe side channel
        (a probe whose arm failed yields no response to watch)."""
        arms = np.asarray(arms, np.int64)
        if arms.size == 0:
            return 0
        cl = np.asarray(clusters, np.int64)
        for cid in np.unique(cl):
            np.add.at(
                self.feedback._buf(int(cid))[1], arms[cl == cid], 1.0
            )
        self.arm_failures += np.bincount(arms, minlength=self.arm_failures.size)
        self.failures += int(arms.size)
        self.routes += 1
        return int(arms.size)

    def stats(self) -> Dict[str, int]:
        return {
            "degradation_failures": self.failures,
            "degradation_degraded": self.degraded,
            "degradation_routes": self.routes,
        }
