"""ThriftLLM router: per-query-class selection + batched wavefront invocation.

The PyTorch port of ``repro/serving/router.py``. Serving pipeline per
batch (Figure 1 of the paper, batched):

  1. map each query's embedding to its historical cluster -> p-hat vector;
  2. group queries by (cluster, budget); SurGreedyLLM selection per group is
     memoized by the :class:`~repro_torch.serving.plans.PlanService`, whose
     misses plan on the router's device, and the derived wave plan (arm
     order, log-weights, Prop. 4 residuals) is what the hot path consumes;
  3. *wavefront* adaptive invocation across the whole batch, on one of two
     data planes with identical semantics for deterministic arms:

     * :meth:`ThriftRouter.route_batch` (``jit_waves=True``, the ``"jit"``
       kind — the name of the reference's jitted plane, kept) — every
       scheduled (query, wave) response is gathered up front in one engine
       call and the whole wave loop runs on the device as one prefix scan
       (:func:`_wave_scan_core`) in float64;
     * :meth:`ThriftRouter.route_batch_reference` — the compacting host
       wavefront: stopped queries leave the in-flight set each wave, so arms
       are only invoked for queries that need them.

  4. belief aggregation: float64 tables by default, or the hand-written
     ``belief_aggregate`` CUDA kernel (``use_kernel=True``; the plain
     PyTorch version on the CPU) — float32 accumulation, so a query whose
     Prop. 4 margin lands within float32 resolution (~1e-7) of the
     STOP_MARGIN boundary may take one wave more or fewer than the float64
     path; everywhere else the two backends agree.

With an active engine fault policy
(:class:`~repro_torch.distributed.fault.FaultPolicy`) both planes read one
host-side fault grid over the original schedule: failed cells yield no
response, degraded cells answer a hash-drawn class, and with ``failover``
a failed arm's wave slot re-routes to the plan's next available arm — on
the device plane through the wave program's ``src``/``valid`` gather, on
the reference plane by rewriting the plan tables up front. Routes report
the *effective* (post-failover) schedule, plus the fault evidence.

Differences from the reference: no ``jit``, compile buckets or donation
(``donate_buffers`` and ``prewarm_compile`` have no counterpart), and
tensors on an explicit ``device``; the failover ``src`` is int64 (torch
gathers take it).
"""
from __future__ import annotations

from typing import Any, List, Optional

import numpy as np
import torch

from repro_torch.core.belief import tie_break_argmax
from repro_torch.core.estimation import SuccessProbEstimator
from repro_torch.core.selection import STOP_MARGIN, ThriftLLM, adaptive_invoke
from repro_torch.distributed.fault import (
    FAULT_DEGRADE,
    FAULT_ERROR,
    FAULT_TIMEOUT,
    failover_gather,
    observed_faults,
)
from repro_torch.kernels import ops

from .engine import PoolEngine
from .plans import PlanService, stack_plans


class RouteResult:
    """Batched routing output of one ``route_batch`` call.

    Attributes:
      predictions: (B,) aggregated class id per query (Eq. 4 argmax with
        shared tie-breaking).
      costs: (B,) realized USD per query — only waves actually invoked.
      planned_costs: (B,) USD of each query's full selected set.
      clusters: (B,) historical cluster each query mapped to.
      budgets: (B,) per-query budget applied.
      schedule: (B, T) arm id scheduled at wave t, ``-1`` = no arm.
      responses: (B, T) class id returned at wave t, ``-1`` = wave not run.
      invoked: (B, T) bool — wave t really ran for this query.
      arm_query_counts: (L,) number of queries each pool arm actually served.
      waves: number of waves the batch executed before every query stopped.
      beliefs: (B, K) float64 log-beliefs each prediction was taken from.

    When the engine carries an active fault policy, ``schedule`` /
    ``responses`` / ``invoked`` / ``costs`` describe the *effective* route
    (what was served after in-wave failover re-routed failed slots), and
    three keyword-only fields carry the failure evidence (all ``None`` on
    fault-free routes):

      fault_schedule: (B, T) the original plan-order schedule.
      fault_codes: (B, T) int8 observed fault per original plan cell
        (``FAULT_TIMEOUT``/``FAULT_ERROR`` at failures the wavefront
        attempted, ``FAULT_DEGRADE`` at silently-degraded cells it served,
        0 everywhere else).
      arm_fault_counts: (L,) attempted timeout/error failures per arm.
    """

    def __init__(
        self,
        predictions: np.ndarray,
        costs: np.ndarray,
        planned_costs: np.ndarray,
        clusters: np.ndarray,
        budgets: np.ndarray,
        schedule: np.ndarray,
        responses: np.ndarray,
        invoked: np.ndarray,
        arm_query_counts: np.ndarray,
        waves: int,
        beliefs: Optional[np.ndarray] = None,
        *,
        fault_schedule: Optional[np.ndarray] = None,
        fault_codes: Optional[np.ndarray] = None,
        arm_fault_counts: Optional[np.ndarray] = None,
    ):
        self.predictions = predictions
        self.costs = costs
        self.planned_costs = planned_costs
        self.clusters = clusters
        self.budgets = budgets
        self.schedule = schedule
        self.responses = responses
        self.invoked = invoked
        self.arm_query_counts = arm_query_counts
        self.waves = waves
        self.beliefs = beliefs
        self.fault_schedule = fault_schedule
        self.fault_codes = fault_codes
        self.arm_fault_counts = arm_fault_counts
        self._arms_used: Optional[List[List[int]]] = None

    @property
    def arms_used(self) -> List[List[int]]:
        """Per query, arms actually invoked in invocation order."""
        if self._arms_used is None:
            self._arms_used = [
                self.schedule[b, self.invoked[b]].tolist()
                for b in range(self.schedule.shape[0])
            ]
        return self._arms_used

    @property
    def stop_waves(self) -> np.ndarray:
        """(B,) number of waves each query invoked before its Prop. 4 stop
        fired."""
        return self.invoked.sum(axis=1)


# ---------------------------------------------------------------------------
# The on-device wave loop
# ---------------------------------------------------------------------------


def _wave_scan_core(
    schedule: torch.Tensor,   # (T, B) int32 arm ids, -1 = none (wave-major)
    responses: torch.Tensor,  # (T, B) int32 precomputed responses, -1 = none
    weights: torch.Tensor,    # (T, B) f64 log belief weight per wave
    residual: torch.Tensor,   # (T, B) f64 Prop. 4 log F residuals
    src: torch.Tensor,        # (T, B) int64 failover gather: original wave
                              #   index serving slot t (identity = no fault)
    valid: torch.Tensor,      # (T, B) bool slot t has an available arm
    empty: torch.Tensor,      # (B,) f64 empty-class log belief
    stop_margin: float,
    *,
    num_classes: int,
    use_kernel: bool,
):
    """The entire wavefront loop on the device.

    Responses are gathered up front, so each query's trajectory is a
    *prefix* of its schedule and the sequential adaptive loop collapses into
    a prefix scan: cumulative (T+1, B, K) belief tables (index t = beliefs
    before wave t), every wave's Prop. 4 stop decision at once, and each
    query's stop wave as the first failing prefix. The prefix sums are an
    explicit chain over t in the host loop's order (bit-identical float64
    beliefs). Under ``use_kernel`` every prefix of every query is one row
    of a single ``belief_aggregate`` launch.

    **In-wave failover** (``src``/``valid``): slot t of each query's wave
    program serves the plan's t-th *available* arm; the gather comes from
    the host-side fault grid as data. Invalid cells read the pad values the
    tables hold there (schedule -1, weight 0, residual -inf), so the
    identity gather of fault-free traffic is a no-op. The gathered residual
    is the original plan's suffix value at the source position — an upper
    bound on the remaining evidence, so Prop. 4 never stops earlier than a
    fault-free run would.

    Returns (stop_wave (B,) — waves invoked per query, predictions (B,)
    first-max argmax, log-beliefs (B, K) at the stop wave).
    """
    T, B = schedule.shape
    K = num_classes
    dev = schedule.device
    f_dtype = weights.dtype
    class_ids = torch.arange(K, dtype=responses.dtype, device=dev)
    neg_inf = torch.tensor(-np.inf, dtype=f_dtype, device=dev)

    schedule = torch.where(valid, torch.gather(schedule, 0, src), -1)
    responses = torch.where(valid, torch.gather(responses, 0, src), -1)
    weights = torch.where(valid, torch.gather(weights, 0, src), 0.0)
    residual = torch.where(valid, torch.gather(residual, 0, src), neg_inf)

    if use_kernel:
        # row (b, t) holds query b's responses masked to waves < t
        resp_bt = responses.T                                   # (B, T)
        seen = torch.arange(T + 1, device=dev)[None, :, None] > torch.arange(T, device=dev)[None, None, :]
        hist = torch.where(seen, resp_bt[:, None, :], -1)      # (B, T+1, T)
        w32 = weights.T.to(torch.float32)
        bel32, _ = ops.belief_aggregate(
            hist.reshape(B * (T + 1), T),
            w32[:, None, :].expand(B, T + 1, T).reshape(-1, T),
            empty.to(torch.float32)[:, None].expand(B, T + 1).reshape(-1),
            K,
        )
        # f32 values compared in f64, as the reference kernel path does
        bel = bel32.reshape(B, T + 1, K).to(f_dtype).transpose(0, 1)
    else:
        onehot = responses[:, :, None] == class_ids             # (T, B, K)
        contrib = torch.where(onehot, weights[:, :, None], 0.0)
        votes = [torch.zeros((B, K), dtype=f_dtype, device=dev)]
        cnts = [torch.zeros((B, K), dtype=torch.bool, device=dev)]
        for t in range(T):
            votes.append(votes[-1] + contrib[t])
            cnts.append(cnts[-1] | onehot[t])
        cumvote = torch.stack(votes)                            # (T+1, B, K)
        cumcnt = torch.stack(cnts)
        bel = torch.where(cumcnt, cumvote, empty[None, :, None])

    # online top-2 over the K axis; ties keep h2 == h1
    h1 = torch.full((T + 1, B), -np.inf, dtype=f_dtype, device=dev)
    h2 = h1
    for k in range(K):
        v = bel[:, :, k]
        gt = v > h1
        h2 = torch.where(gt, h1, torch.maximum(h2, v))
        h1 = torch.where(gt, v, h1)
    stop = ~((schedule >= 0) & (residual + h2[:T] > h1[:T] - stop_margin))
    first = torch.argmax(stop.to(torch.int32), dim=0)           # first stop
    s = torch.where(stop.any(dim=0), first, T)
    beliefs = torch.gather(bel, 0, s[None, :, None].expand(1, B, K))[0]
    preds = torch.argmax(beliefs, dim=-1)                       # first max
    return s, preds, beliefs


class PendingRoute:
    """One in-flight batched route, created by :meth:`ThriftRouter.begin_route`.

    Three kinds:

    * ``"jit"`` — the speculative device wave loop. Planning, the response
      gather and the device launch happen in ``begin_route``; the device
      work may still be running when the handle is returned (CUDA launches
      are asynchronous). ``result()`` copies the values back and finalizes.
    * ``"reference"`` — the compacting host wavefront, exposed wave by wave:
      each ``step()`` evaluates the Prop. 4 stop rule, retires the queries
      whose stop fired (returning their rows and, without a tie-break rng,
      their final predictions), then invokes one wave of arms for the
      queries still in flight. ``result()`` steps to exhaustion.
    * ``"empty"`` — a zero-query batch; ``result()`` is immediate.

    The handle is single-use: ``result()`` caches and re-returns.
    """

    def __init__(self, router: "ThriftRouter", kind: str, result=None, **state):
        self.router = router
        self.kind = kind
        self.spec_cost = state.pop("spec_cost", 0.0)
        # estimator plan-version the group's plans were gathered at (a served
        # group can be attributed to the estimate generation that planned it)
        self.plan_version = state.pop("plan_version", 0)
        self._result: Optional[RouteResult] = result
        if result is not None:
            return
        self.budgets = state.pop("budgets")
        self.cluster_ids = state.pop("cluster_ids")
        self.sched_T = state.pop("sched_T")
        self.w_T = state.pop("w_T")
        self.res_T = state.pop("res_T")
        self.wc_T = state.pop("wc_T")
        self.empty = state.pop("empty")
        self.planned = state.pop("planned")
        self.payloads = state.pop("payloads")
        self.stop_margin = state.pop("stop_margin")
        self.rng = state.pop("rng")
        # batch-row offset of this group inside a logically fused batch —
        # keeps per-worker fault draws identical to the fused dispatch's
        self.fault_row_offset = int(state.pop("fault_row_offset", 0))
        if state:
            raise TypeError(f"unknown PendingRoute state {sorted(state)}")
        self.B = int(self.budgets.shape[0])
        self.T = int(self.sched_T.shape[0])
        self.L = len(router.engine.arms)
        if kind == "reference":
            self._prepare_reference_faults()
            self._init_reference()

    # ------------------------------------------------------------------
    # jit kind: speculative gather + asynchronous device launch
    # ------------------------------------------------------------------
    def _dispatch_jit(self):
        router, T, B = self.router, self.T, self.B
        sched_T, engine = self.sched_T, router.engine
        codes, failed = engine.fault_grid(sched_T, row_offset=self.fault_row_offset)
        self._orig_sched_T = sched_T
        self._codes, self._failed = codes, failed
        # one heterogeneous-arm engine call for every scheduled cell; the
        # device program decides which cells the adaptive loop uses
        if engine.pooled:
            resp_T = engine.invoke_grid(sched_T, self.payloads)
        else:
            mask = sched_T >= 0
            if failed is not None:
                mask &= ~failed          # a failed arm yields no response
            _, rows_b = np.nonzero(mask)
            resp_T = np.full((T, B), -1, np.int64)
            if rows_b.size:
                resp_T[mask] = engine.invoke_rows(sched_T[mask], self.payloads, rows_b)
        if codes is not None:
            resp_T = np.where(failed, -1, resp_T)
            degr = codes == FAULT_DEGRADE
            if degr.any():
                # silent degradation: the arm answers (and bills), but with a
                # hash-drawn class — response-independent, so the reference
                # plane corrupts the same cells to the same classes
                resp_T = np.where(
                    degr,
                    engine.fault_policy.corrupt_grid(sched_T, row_offset=self.fault_row_offset),
                    resp_T,
                )
        self.resp_T = resp_T

        dev = router.device
        put = lambda x, dtype: torch.as_tensor(np.ascontiguousarray(x), device=dev).to(dtype)
        # in-wave failover gather: identity on fault-free traffic
        if failed is not None and router.failover:
            src, valid, self._rank, self._navail = failover_gather(sched_T, failed)
            src_d = put(src, torch.int64)
        else:
            src = np.broadcast_to(np.arange(T)[:, None], (T, B))
            valid = sched_T >= 0
            self._rank = self._navail = None
            src_d = torch.arange(T, device=dev)[:, None].expand(T, B)
        self._src, self._valid = src, valid
        self._dev = _wave_scan_core(
            put(sched_T, torch.int32), put(resp_T, torch.int32),
            put(self.w_T, torch.float64), put(self.res_T, torch.float64),
            src_d, put(valid, torch.bool), put(self.empty, torch.float64),
            self.stop_margin,
            num_classes=router.num_classes, use_kernel=router.use_kernel,
        )
        self._done = torch.cuda.Event() if dev.type == "cuda" else None
        if self._done is not None:
            self._done.record(torch.cuda.current_stream(dev))

    def ready(self) -> bool:
        """Non-blocking: has the launched device work finished? Host-driven
        kinds (reference/empty) are always ready."""
        if self.kind != "jit" or self._result is not None or self._done is None:
            return True
        return bool(self._done.query())

    def _fault_kwargs(self, stop_wave: np.ndarray) -> dict:
        """Fault-evidence fields for RouteResult; {} on fault-free routes."""
        codes = getattr(self, "_codes", None)
        if codes is None:
            return {}
        obs = observed_faults(codes, self._orig_sched_T, stop_wave, self._rank, self._navail)
        hit = (obs == FAULT_TIMEOUT) | (obs == FAULT_ERROR)
        return dict(
            fault_schedule=self._orig_sched_T.T,
            fault_codes=obs.T,
            arm_fault_counts=np.bincount(self._orig_sched_T[hit], minlength=self.L),
        )

    def _finalize_jit(self) -> RouteResult:
        s_d, pred_d, beliefs_d = self._dev
        B, T, L = self.B, self.T, self.L
        stop_wave = s_d.cpu().numpy()
        beliefs = beliefs_d.cpu().numpy()
        if self.rng is None:
            predictions = pred_d.cpu().numpy().astype(np.int64)
        else:
            predictions, _ = tie_break_argmax(beliefs, self.rng)
        if self._failed is None:
            sched_T = self.sched_T
            invoked_T = np.arange(T)[:, None] < stop_wave[None, :]
            costs = np.where(invoked_T, self.wc_T, 0.0).sum(axis=0)
            responses_T = np.where(invoked_T, self.resp_T, -1)
        else:
            # report the *effective* route — post-failover schedule, the
            # responses actually obtained, spend charged for the arms
            # actually invoked — so downstream accounting stays fault-blind
            src, valid = self._src, self._valid
            bb = np.broadcast_to(np.arange(B)[None, :], (T, B))
            sched_T = np.where(valid, self.sched_T[src, bb], -1)
            resp_eff = np.where(valid, self.resp_T[src, bb], -1)
            wc_eff = np.where(valid, self.wc_T[src, bb], 0.0)
            invoked_T = (np.arange(T)[:, None] < stop_wave[None, :]) & (sched_T >= 0)
            if not self.router.failover:
                # frozen plans: a failed slot's wave still elapses, but the
                # arm never answered — not served, not charged
                invoked_T &= ~self._failed
            costs = np.where(invoked_T, wc_eff, 0.0).sum(axis=0)
            responses_T = np.where(invoked_T, resp_eff, -1)
        return RouteResult(
            predictions=predictions,
            costs=costs,
            planned_costs=self.planned,
            clusters=self.cluster_ids,
            budgets=np.asarray(self.budgets),
            schedule=sched_T.T,
            responses=responses_T.T,
            invoked=invoked_T.T,
            arm_query_counts=np.bincount(sched_T[invoked_T], minlength=L),
            waves=int(invoked_T.any(axis=1).sum()),
            beliefs=beliefs,
            **self._fault_kwargs(stop_wave),
        )

    # ------------------------------------------------------------------
    # reference kind: compacting wavefront, one step() per wave
    # ------------------------------------------------------------------
    def _prepare_reference_faults(self):
        """Mirror the device plane's fault handling on the host wavefront:
        the same single fault grid and failover gather, materialized into
        the plan tables up front (the compacting loop then runs unchanged
        over the *effective* plan)."""
        engine = self.router.engine
        codes, failed = engine.fault_grid(self.sched_T, row_offset=self.fault_row_offset)
        self._orig_sched_T = self.sched_T
        self._codes, self._failed = codes, failed
        self._rank = self._navail = None
        self._degrade_T = None
        if codes is None:
            return
        T, B = self.sched_T.shape
        degr = codes == FAULT_DEGRADE
        corrupt = None
        if degr.any():
            corrupt = np.where(
                degr,
                engine.fault_policy.corrupt_grid(self.sched_T, row_offset=self.fault_row_offset),
                -1,
            )
        if self.router.failover:
            src, valid, self._rank, self._navail = failover_gather(self.sched_T, failed)
            bb = np.broadcast_to(np.arange(B)[None, :], (T, B))
            self.sched_T = np.where(valid, self.sched_T[src, bb], -1)
            self.w_T = np.where(valid, self.w_T[src, bb], 0.0)
            self.res_T = np.where(valid, self.res_T[src, bb], -np.inf)
            self.wc_T = np.where(valid, self.wc_T[src, bb], 0.0)
            if corrupt is not None:
                self._degrade_T = np.where(valid, corrupt[src, bb], -1)
        else:
            self._degrade_T = corrupt

    def _init_reference(self):
        B, K = self.B, self.router.num_classes
        self.weights = self.w_T.T                # (B, T) view for the kernel
        self.resp_T = np.full((self.T, B), -1, np.int64)
        self.vote = np.zeros((B, K), np.float64)  # scatter-add log-weight table
        self.voted = np.zeros((B, K), bool)       # any vote -> real belief
        self.costs = np.zeros(B, np.float64)
        self.arm_query_counts = np.zeros(self.L, np.int64)
        self.cur = np.arange(B)                   # queries still in flight
        self.stop_at = np.full(B, self.T, np.int64)
        self.waves = 0
        self._t = 0
        self._exhausted = False

    def _beliefs_rows(self, rows: np.ndarray) -> np.ndarray:
        if self.router.use_kernel:
            # rows are independent: feeding only in-flight rows gives the
            # same beliefs at a fraction of the kernel work
            return self.router._kernel_beliefs(
                np.ascontiguousarray(self.resp_T.T[rows]),
                self.weights[rows], self.empty[rows],
            )
        return np.where(self.voted[rows], self.vote[rows], self.empty[rows][:, None])

    @property
    def exhausted(self) -> bool:
        """True once every query has left the wavefront (reference kind)."""
        return self.kind != "reference" or self._exhausted

    def step(self):
        """Advance the compacting wavefront one wave (reference kind only).

        Returns ``(rows, predictions)`` for the queries that completed this
        wave — their Prop. 4 stop fired, or the schedule ran out.
        ``predictions`` carries their final class ids when no tie-break rng
        is in play; with an rng it is None and every prediction is drawn at
        finalization. After exhaustion returns empty rows.
        """
        if self.kind != "reference":
            raise RuntimeError("step() is for reference routes")
        K = self.router.num_classes
        if self._exhausted:
            return np.zeros(0, np.int64), np.zeros(0, np.int64)
        cur, t = self.cur, self._t
        bel = self._beliefs_rows(cur)
        if t >= self.T:
            # schedule exhausted: everything still in flight completes now
            self._exhausted = True
            self.cur = np.zeros(0, np.int64)
            preds = tie_break_argmax(bel)[0] if self.rng is None else None
            return cur, preds
        # Prop. 4 early stop on the in-flight set, one mask per wave
        if K >= 2:
            part = np.partition(bel, K - 2, axis=1)
            h1, h2 = part[:, K - 1], part[:, K - 2]
        else:
            h1, h2 = bel[:, 0], np.full(cur.size, -np.inf)
        sched_t = self.sched_T[t]
        keep = (sched_t[cur] >= 0) & (self.res_T[t][cur] + h2 > h1 - self.stop_margin)
        stopped = cur[~keep]
        self.stop_at[stopped] = t
        preds = None
        if self.rng is None and stopped.size:
            preds = tie_break_argmax(bel[~keep])[0]
        elif self.rng is None:
            preds = np.zeros(0, np.int64)
        self.cur = cur = cur[keep]
        self._t = t + 1
        if cur.size == 0:
            self._exhausted = True
            return stopped, preds
        live = cur
        if self._failed is not None and not self.router.failover:
            # frozen plans under faults: the wave elapses for every in-flight
            # query, but failed arms are never invoked, charged, or counted
            live = cur[~self._failed[t][cur]]
        if live.size:
            self.waves += 1
            arms_t = sched_t[live]
            votes = self.router.engine.invoke_rows(arms_t, self.payloads, live)
            if self._degrade_T is not None:
                ov = self._degrade_T[t][live]
                votes = np.where(ov >= 0, ov, votes)
            self.arm_query_counts += np.bincount(arms_t, minlength=self.L)
            self.vote[live, votes] += self.w_T[t][live]
            self.voted[live, votes] = True
            self.costs[live] += self.wc_T[t][live]
            self.resp_T[t][live] = votes
        return stopped, preds

    def _finalize_reference(self) -> RouteResult:
        while not self._exhausted:
            self.step()
        responses = np.ascontiguousarray(self.resp_T.T)
        if self.router.use_kernel:
            beliefs = self.router._kernel_beliefs(responses, self.weights, self.empty)
        else:
            beliefs = np.where(self.voted, self.vote, self.empty[:, None])
        predictions, _ = tie_break_argmax(beliefs, self.rng)
        return RouteResult(
            predictions=predictions,
            costs=self.costs,
            planned_costs=self.planned,
            clusters=self.cluster_ids,
            budgets=np.asarray(self.budgets),
            schedule=self.sched_T.T,
            responses=responses,
            invoked=responses >= 0,
            arm_query_counts=self.arm_query_counts,
            waves=self.waves,
            beliefs=beliefs,
            **self._fault_kwargs(self.stop_at),
        )

    # ------------------------------------------------------------------
    def result(self) -> RouteResult:
        """Block until the route completes and return its RouteResult
        (cached — safe to call repeatedly)."""
        if self._result is None:
            self._result = (
                self._finalize_jit() if self.kind == "jit"
                else self._finalize_reference()
            )
        return self._result


class ThriftRouter:
    """Batched ThriftLLM serving router.

    Args:
      engine: arm pool executor.
      estimator: cluster -> p-hat success-probability estimator.
      num_classes: label-space size K.
      eps, delta, seed: SurGreedy Monte-Carlo parameters (paper Sec. 5).
      use_kernel: aggregate beliefs with the ``belief_aggregate`` kernel
        (float32) and score the serial planner's candidates with the
        ``mc_correctness_grouped`` kernel.
      jit_waves: run the wave loop on the device (:meth:`route_batch`);
        ``False`` routes through the compacting host loop
        (:meth:`route_batch_reference`), which never invokes arms
        speculatively.
      failover: with an active engine fault policy, re-route a failed arm's
        wave slot to the plan's next-best affordable arm inside the wave
        program (both planes, identical semantics); ``False`` freezes the
        plan — failed slots lose their vote (and are not charged).
        Irrelevant without injected faults.
      plan_service: optionally share a :class:`PlanService` across routers
        bound to the same pool; by default each router owns one.
      device: where planning and the wave loop run. A CUDA device must
        exist when one is named; nothing falls back to the CPU.
    """

    def __init__(
        self,
        engine: PoolEngine,
        estimator: SuccessProbEstimator,
        num_classes: int,
        eps: float = 0.1,
        delta: float = 0.01,
        seed: int = 0,
        use_kernel: bool = False,
        jit_waves: bool = True,
        failover: bool = True,
        plan_service: Optional[PlanService] = None,
        device="cuda",
    ):
        self.engine = engine
        self.estimator = estimator
        self.num_classes = int(num_classes)
        self.use_kernel = bool(use_kernel)
        self.jit_waves = bool(jit_waves)
        self.failover = bool(failover)
        self.device = torch.device(device)
        self.selector = ThriftLLM(
            engine.costs, eps=eps, delta=delta, seed=seed, use_kernel=use_kernel,
            device=str(self.device),
        )
        self.plans = plan_service or PlanService(
            self.selector, estimator, engine, self.num_classes
        )

    # ------------------------------------------------------------------
    # Planning: (cluster, budget) groups -> one cross-group wave schedule
    # ------------------------------------------------------------------
    def _batch_plan(self, cluster_ids: np.ndarray, budgets: np.ndarray):
        """Merge per-group plans into batch-wide *wave-major* matrices for a
        heterogeneous-budget batch: ``(schedule (T, B), weights (T, B),
        residual (T, B), wave_costs (T, B), empty (B,), planned (B,))``."""
        b_vals, b_inv = np.unique(budgets, return_inverse=True)
        c_vals, c_inv = np.unique(cluster_ids, return_inverse=True)
        combo_vals, inverse = np.unique(c_inv * b_vals.size + b_inv, return_inverse=True)
        group_keys = [
            (int(c_vals[v // b_vals.size]), float(b_vals[v % b_vals.size]))
            for v in combo_vals
        ]
        plans = [self.plans.plan(c, b) for c, b in group_keys]
        order_m, fp_m, empty_v, planned_v = stack_plans(plans)
        fp_b = fp_m[:, :, inverse]                 # one gather for all floats
        return (
            order_m[:, inverse], fp_b[0], fp_b[1], fp_b[2],
            empty_v[inverse], planned_v[inverse],
        )

    def _plan_batch(self, embeddings: np.ndarray, budgets: np.ndarray):
        """Shared planning prologue of both batched paths: uniform-budget
        batches gather from the PlanService's cached batch tables; mixed
        budgets merge per-group plans. Returns ``(cluster_ids (B,),
        schedule (T, B), weights (T, B), residual (T, B), wave_costs (T, B),
        empty (B,), planned (B,))``."""
        if budgets[0] == budgets[-1] and (budgets == budgets[0]).all():
            idx = self.estimator.lookup_batch_indices(embeddings)
            cluster_ids = self.estimator.cluster_order[idx]
            tabs = self.plans.batch_tables(float(budgets[0]), idx=idx)
            fp = tabs.floats[:, :, idx]
            return (
                cluster_ids, tabs.order[:, idx], fp[0], fp[1], fp[2],
                tabs.empty[idx], tabs.planned[idx],
            )
        cluster_ids = self.estimator.lookup_batch(embeddings)
        return (cluster_ids,) + self._batch_plan(cluster_ids, budgets)

    def _empty_result(self, budgets: np.ndarray) -> RouteResult:
        return RouteResult(
            predictions=np.zeros(0, np.int64),
            costs=np.zeros(0, np.float64),
            planned_costs=np.zeros(0, np.float64),
            clusters=np.zeros(0, np.int64),
            budgets=np.asarray(budgets),
            schedule=np.full((0, 1), -1, np.int64),
            responses=np.full((0, 1), -1, np.int64),
            invoked=np.zeros((0, 1), bool),
            arm_query_counts=np.zeros(len(self.engine.arms), np.int64),
            waves=0,
        )

    # ------------------------------------------------------------------
    # Belief backend of the reference plane under use_kernel
    # ------------------------------------------------------------------
    def _kernel_beliefs(
        self, responses: np.ndarray, weights: np.ndarray, empty: np.ndarray
    ) -> np.ndarray:
        put = lambda x, dtype: torch.as_tensor(np.ascontiguousarray(x), device=self.device).to(dtype)
        bel, _ = ops.belief_aggregate(
            put(responses, torch.int32), put(weights, torch.float32),
            put(empty, torch.float32), self.num_classes,
        )
        return bel.to(torch.float64).cpu().numpy()

    # ------------------------------------------------------------------
    def speculation_cost(self, sched_T: np.ndarray, wc_T: np.ndarray) -> float:
        """Mean per-query USD the speculative all-cells gather would bill to
        *metered* arms beyond what any query could realize; unmetered arms
        contribute zero."""
        metered = self.engine.metered_mask
        if not metered.any():
            return 0.0
        billed = (sched_T >= 0) & metered[np.maximum(sched_T, 0)]
        return float(np.where(billed, wc_T, 0.0).sum() / max(sched_T.shape[1], 1))

    # ------------------------------------------------------------------
    def begin_route(
        self,
        queries: Any,                    # arm payloads, len B (array or list)
        embeddings: np.ndarray,          # (B, d)
        budget: Any,                     # scalar or (B,) per-query budgets
        stop_margin: float = STOP_MARGIN,
        rng: Optional[np.random.Generator] = None,
        mode: str = "auto",
        speculation_threshold: float = 0.0,
        fault_row_offset: int = 0,
    ) -> PendingRoute:
        """Start routing a batch and return a :class:`PendingRoute` handle:
        planning, the data-plane choice and (for the ``"jit"`` kind) the
        speculative gather and device launch happen here; ``result()``
        finalizes.

        Args:
          mode: ``"jit"`` forces the device wave loop, ``"reference"`` the
            compacting host wavefront, and ``"auto"`` picks ``"jit"`` when
            :meth:`speculation_cost` is at most ``speculation_threshold``
            (and the router is not pinned to the reference plane).
          fault_row_offset: this batch's starting row inside a logically
            fused batch, so fault draws (keyed on batch row) equal the
            single fused dispatch's.
        """
        B = len(queries)
        budgets = np.broadcast_to(np.asarray(budget, np.float64), (B,))
        if B == 0:
            return PendingRoute(self, "empty", result=self._empty_result(budgets))
        self.plans.refresh()
        cluster_ids, sched_T, w_T, res_T, wc_T, empty, planned = self._plan_batch(
            embeddings, budgets
        )
        spec_cost = self.speculation_cost(sched_T, wc_T)
        if mode == "auto":
            kind = "reference" if (not self.jit_waves or spec_cost > speculation_threshold) else "jit"
        elif mode in ("jit", "reference"):
            kind = mode
        else:
            raise ValueError(f"unknown route mode {mode!r}")
        pending = PendingRoute(
            self, kind,
            budgets=budgets, cluster_ids=cluster_ids, sched_T=sched_T,
            w_T=w_T, res_T=res_T, wc_T=wc_T, empty=empty, planned=planned,
            payloads=self.engine.prepare_payloads(queries),
            stop_margin=float(stop_margin), rng=rng, spec_cost=spec_cost,
            plan_version=getattr(self.estimator, "plan_version", 0),
            fault_row_offset=fault_row_offset,
        )
        if kind == "jit":
            pending._dispatch_jit()
        return pending

    # ------------------------------------------------------------------
    def route_batch(
        self,
        queries: Any,
        embeddings: np.ndarray,
        budget: Any,
        stop_margin: float = STOP_MARGIN,
        rng: Optional[np.random.Generator] = None,
    ) -> RouteResult:
        """Route a batch end to end: cluster lookup, plan-cache gather, the
        device wave loop (or, with ``jit_waves=False``, the compacting host
        loop), host-side finalization.

        Args:
          queries: per-arm payloads ((cluster, label) pairs for oracle pools).
          embeddings: (B, d) query embeddings for cluster lookup.
          budget: scalar or (B,) per-query USD budgets.
          stop_margin: Prop. 4 slack; keep the default for paper semantics.
          rng: optional generator for belief-tie breaking (None = argmax).
        """
        mode = "jit" if self.jit_waves else "reference"
        return self.begin_route(
            queries, embeddings, budget, stop_margin=stop_margin, rng=rng, mode=mode,
        ).result()

    # ------------------------------------------------------------------
    def route_batch_reference(
        self,
        queries: Any,
        embeddings: np.ndarray,
        budget: Any,
        stop_margin: float = STOP_MARGIN,
        rng: Optional[np.random.Generator] = None,
    ) -> RouteResult:
        """Compacting host-side wavefront — the semantics reference of
        :meth:`route_batch` and the plane for pools where speculative
        invocation costs real money."""
        return self.begin_route(
            queries, embeddings, budget, stop_margin=stop_margin, rng=rng,
            mode="reference",
        ).result()

    # ------------------------------------------------------------------
    def route_batch_sequential(
        self,
        queries: Any,
        embeddings: np.ndarray,
        budget: Any,
        rng: Optional[np.random.Generator] = None,
    ) -> RouteResult:
        """Sequential oracle: one ``adaptive_invoke`` per query, sharing the
        plan service's selection cache. Exact output equality with
        :meth:`route_batch` holds for deterministic arms; stochastic oracle
        pools consume their rng streams in another order here."""
        B = len(queries)
        K = self.num_classes
        budgets = np.broadcast_to(np.asarray(budget, np.float64), (B,))
        self.plans.refresh()
        cluster_ids = self.estimator.lookup_batch(embeddings)
        L = len(self.engine.arms)

        predictions = np.zeros(B, np.int64)
        costs = np.zeros(B, np.float64)
        planned = np.zeros(B, np.float64)
        beliefs = np.zeros((B, K), np.float64)
        arms_used: List[List[int]] = []
        resp_rows: List[np.ndarray] = []
        arm_query_counts = np.zeros(L, np.int64)
        for j in range(B):
            p = self.estimator.clusters[int(cluster_ids[j])].p_hat
            sel = self.selector.select(p, K, float(budgets[j]))

            def invoke_one(arm: int) -> int:
                mask = np.zeros(B, bool)
                mask[j] = True
                return int(self.engine.invoke_arm(int(arm), queries, mask)[j])

            inv = adaptive_invoke(
                list(sel.chosen), p, K, invoke_one, rng=rng, costs=self.engine.costs
            )
            predictions[j] = inv.prediction
            costs[j] = inv.cost
            planned[j] = inv.planned_cost
            beliefs[j] = inv.log_beliefs
            arms_used.append([int(a) for a in inv.used])
            resp_rows.append(np.asarray(inv.responses, np.int64))
            arm_query_counts[inv.used] += 1
        T = max(1, max((len(a) for a in arms_used), default=1))
        schedule = np.full((B, T), -1, np.int64)
        responses = np.full((B, T), -1, np.int64)
        invoked = np.zeros((B, T), bool)
        for j, used in enumerate(arms_used):
            schedule[j, : len(used)] = used
            responses[j, : len(used)] = resp_rows[j]
            invoked[j, : len(used)] = True
        res = RouteResult(
            predictions=predictions,
            costs=costs,
            planned_costs=planned,
            clusters=cluster_ids,
            budgets=np.asarray(budgets),
            schedule=schedule,
            responses=responses,
            invoked=invoked,
            arm_query_counts=arm_query_counts,
            waves=T,
            beliefs=beliefs,
        )
        res._arms_used = arms_used
        return res
