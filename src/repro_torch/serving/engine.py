"""Model-pool execution engine (host numpy; the PyTorch port's copy of
``repro/serving/engine.py``).

Each *arm* of the ensemble is an operator with a uniform interface:
``classify_batch(queries) -> class ids`` plus a per-query cost and a
simulated latency. Two arm families:

  * :class:`LMArm` — a model of the port (:class:`repro_torch.models.LM`)
    classifying by the argmax over the class-signature token logits at the
    answer position, run on the model's device;
  * :class:`OracleArm` — Bernoulli oracles from the synthetic workload,
    drawing from numpy generators exactly as the reference does, so both
    packages answer the same queries identically.

An optional :class:`~repro_torch.distributed.fault.FaultPolicy` injects
arm faults; :meth:`PoolEngine.fault_grid` evaluates it on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.distributed.fault import FAULT_ERROR, FAULT_TIMEOUT
from repro_torch.models import LM

USD_PER_FLOP = 3.5e-18          # calibrated so pool prices match Table 4's range


@dataclasses.dataclass
class LMArm:
    """A real model arm. ``classify_batch`` takes the argmax over the
    class-signature token logits at the answer position.

    The JAX arm's ``params`` field has no counterpart: the ``nn.Module``
    ``model`` owns its weights (and its device)."""

    name: str
    model: LM
    class_token_ids: np.ndarray
    tokens_per_query: int = 128
    # Self-hosted model: invoking it costs FLOPs we already own, not metered
    # API dollars — speculative invocation is free throughput.
    metered: bool = False

    def __post_init__(self):
        cfg = self.model.cfg
        self.flops_per_query = cfg.flops_per_token(self.tokens_per_query) * self.tokens_per_query / 3.0
        self.cost = float(self.flops_per_query * USD_PER_FLOP)

    def classify_batch(self, tokens: np.ndarray) -> np.ndarray:
        """tokens (B, S) — the answer position is the final token slot."""
        dev = self.model.device
        x = torch.as_tensor(np.asarray(tokens)[:, :-1], device=dev).long()
        cls = torch.as_tensor(np.asarray(self.class_token_ids), device=dev).long()
        with torch.inference_mode():
            last = self.model(x)[:, -1]                          # predicts final slot
            pred = last[:, cls].argmax(dim=-1)
        return pred.cpu().numpy().astype(np.int64)

    def latency_s(self, batch: int) -> float:
        return 1e-12 * self.flops_per_query * batch            # simulated


@dataclasses.dataclass
class OracleArm:
    """Bernoulli oracle arm over an OracleWorkload."""

    name: str
    workload: Any
    arm_index: int
    seed: int = 0
    # Set True to model a metered upstream API arm: every invocation bills
    # real money, so the router's speculation switch (see
    # ``ThriftRouter.begin_route``) must not gather its responses for waves
    # the Prop. 4 stop rule may cancel.
    metered: bool = False

    def __post_init__(self):
        self.cost = float(self.workload.costs[self.arm_index])
        self._rng = np.random.default_rng(self.seed + 7919 * self.arm_index)
        # simulated per-query latency, snapshotted once (latency_s sits on
        # the scheduler's per-flush accounting path)
        self._lat_per_query = 1e-4 * self.cost / max(
            float(self.workload.costs.min()), 1e-12
        )

    def classify_batch(self, queries: Sequence) -> np.ndarray:
        """queries: sequence of (cluster_id, label) — fully vectorized so
        oracle-pool throughput benchmarks measure the router, not the oracle."""
        q = np.asarray(queries, np.int64).reshape(-1, 2)
        return self.workload.invoke_batch(self.arm_index, q[:, 0], q[:, 1], self._rng)

    def latency_s(self, batch: int) -> float:
        return self._lat_per_query * batch


@dataclasses.dataclass
class PoolEngine:
    """Holds the arm pool; executes per-arm batched calls with accounting.

    When every arm is an :class:`OracleArm` over one shared workload, the
    engine exposes a pooled fast path: a wave of heterogeneous arm
    assignments is answered by a single vectorized ``invoke_assigned`` call
    (one rng draw per query) instead of one ``classify_batch`` per distinct
    arm. Mixed or model-backed pools fall back to grouped per-arm calls.
    """

    arms: List[Any]
    # Optional arm-level fault injection (see repro_torch.distributed.fault):
    # draws are evaluated on the host on the original wave schedule. None /
    # inactive policies cost nothing.
    fault_policy: Optional[Any] = None

    def __post_init__(self):
        self._workload = None
        if self.arms and all(isinstance(a, OracleArm) for a in self.arms):
            workloads = {id(a.workload) for a in self.arms}
            if len(workloads) == 1:
                self._workload = self.arms[0].workload
                self._workload_arm = np.asarray(
                    [a.arm_index for a in self.arms], np.int64
                )
                # SFC64: ~2x faster than PCG64 for the pooled draw that
                # dominates speculative grid invocation; any counter-based
                # generator is fine for the synthetic oracle
                self._pool_rng = np.random.Generator(
                    np.random.SFC64(self.arms[0].seed + 104729)
                )

    @property
    def costs(self) -> np.ndarray:
        return np.asarray([a.cost for a in self.arms], np.float64)

    @property
    def metered_mask(self) -> np.ndarray:
        """(L,) bool — arms whose invocations bill a metered upstream API.
        Arms without a ``metered`` attribute count as unmetered (oracle /
        tabular / self-hosted pools), so speculation stays free for them."""
        return np.asarray(
            [bool(getattr(a, "metered", False)) for a in self.arms], bool
        )

    @property
    def any_metered(self) -> bool:
        return bool(self.metered_mask.any())

    @property
    def pooled(self) -> bool:
        """True when every arm shares one oracle workload, enabling the
        single-call heterogeneous fast paths (``invoke_rows`` pooled draw,
        the router's all-cells speculative gather)."""
        return self._workload is not None

    def fault_grid(self, sched_T: np.ndarray, row_offset: int = 0):
        """(codes, failed) for a wave schedule, or (None, None) when no
        active fault policy is attached. ``codes`` is the (T, B) int8 fault
        grid (see FAULT_* in repro_torch.distributed.fault); ``failed``
        marks cells whose arm produced no usable response (timeout or error
        — silently-degraded cells still answer, just wrongly).

        ``row_offset`` positions this schedule's rows inside a logically
        fused batch so per-worker draws match the fused dispatch cell for
        cell."""
        policy = self.fault_policy
        if policy is None or not policy.active:
            return None, None
        codes = policy.grid_codes(sched_T, row_offset=row_offset)
        return codes, (codes == FAULT_TIMEOUT) | (codes == FAULT_ERROR)

    def fingerprint(self) -> bytes:
        """Digest of the pool's pricing identity. The PlanService folds this
        into every plan-cache key, so re-pricing an arm (or swapping the
        pool) invalidates cached selections instead of serving stale plans."""
        return np.ascontiguousarray(self.costs).tobytes()

    def prepare_payloads(self, queries) -> Any:
        """One-time per-batch payload conversion for fast row gathering."""
        if self._workload is not None:
            return np.asarray(queries, np.int64)    # (B, 2) (cluster, label)
        if isinstance(queries, np.ndarray):
            return queries
        try:
            arr = np.asarray(queries)
        except ValueError:      # ragged payloads stay a list
            return queries
        return queries if arr.dtype == object else arr

    def invoke_arm(self, arm_idx: int, queries, active: np.ndarray) -> np.ndarray:
        """Run one arm on the active subset; inactive slots return -1."""
        out = np.full(len(queries), -1, np.int64)
        idx = np.flatnonzero(active)
        if idx.size == 0:
            return out
        if isinstance(queries, np.ndarray):
            sub = queries[idx]
        else:
            sub = [queries[i] for i in idx]
        out[idx] = self.arms[arm_idx].classify_batch(sub)
        return out

    def invoke_grid(self, sched_T: np.ndarray, payloads: np.ndarray) -> np.ndarray:
        """Whole-grid pooled invocation: serve cell (t, b) with arm
        ``sched_T[t, b]`` (cells flagged -1 are drawn on arm 0 — callers
        mask them out). Pooled-workload engines only; broadcasts the
        (cluster, label) payload columns instead of gathering rows, so the
        router's speculative gather is a single vectorized draw.

        Returns (T, B) class ids."""
        assert self._workload is not None, "invoke_grid needs a pooled engine"
        T, B = sched_T.shape
        arms = self._workload_arm[np.maximum(sched_T.ravel(), 0)]
        cl = np.broadcast_to(payloads[:, 0], (T, B)).reshape(-1)
        lab = np.broadcast_to(payloads[:, 1], (T, B)).reshape(-1)
        return self._workload.invoke_assigned(
            arms, cl, lab, self._pool_rng
        ).reshape(T, B)

    def invoke_rows(
        self, arm_ids: np.ndarray, queries, rows: np.ndarray
    ) -> np.ndarray:
        """One wavefront step: query ``rows[i]`` is served by ``arm_ids[i]``.

        Returns (n,) class ids aligned with ``rows``. ``queries`` should be
        the output of :meth:`prepare_payloads`.
        """
        arm_ids = np.asarray(arm_ids, np.int64)
        rows = np.asarray(rows, np.int64)
        if rows.size == 0:
            return np.zeros(0, np.int64)
        if self._workload is not None:
            if not isinstance(queries, np.ndarray):
                queries = np.asarray(queries, np.int64)
            q = queries[rows]
            return self._workload.invoke_assigned(
                self._workload_arm[arm_ids], q[:, 0], q[:, 1], self._pool_rng
            )
        out = np.empty(rows.size, np.int64)
        for a in np.unique(arm_ids):
            m = arm_ids == a
            sel = rows[m]
            if isinstance(queries, np.ndarray):
                sub = queries[sel]
            else:
                sub = [queries[i] for i in sel]
            out[m] = self.arms[int(a)].classify_batch(sub)
        return out
