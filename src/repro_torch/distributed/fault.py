"""Arm-level fault injection for the serving plane, and straggler tracking.

Host numpy: the PyTorch port's copy of the serving half of
``repro/distributed/fault.py`` (``FAULT_*``, ``PROBE_WAVE``, the stateless
uint64 cell hash, :class:`ArmFaultSpec`, :class:`FaultPolicy`,
:func:`failover_gather`, :func:`attempted_failures`,
:func:`observed_faults` and :class:`StragglerMitigator`), kept bit for bit
so both packages draw the same faults for the same cells. The training half
(heartbeats, elastic re-meshing, the checkpoint/restart driver) has no
counterpart yet.

Fault draws are a pure counter-based hash evaluated on the host over the
original wave schedule; the device wave program only ever sees the
resulting ``src``/``valid`` failover gather as data tensors.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass
class StragglerMitigator:
    """Per-step worker timing tracker with hedged-work decisions.

    A worker is a straggler when its step time exceeds
    ``threshold x median`` over a sliding window. Mitigation hooks:
      * training: drop the row's contribution this step (bounded staleness)
        and rescale the gradient, or
      * serving: hedge — re-issue the slow arm's request to a replica; for
        ThriftLLM ensembles the adaptive early-stop (Prop. 4) often makes
        the straggler's response unnecessary, so the hedge is free.
    """

    num_workers: int
    window: int = 20
    threshold: float = 2.0

    def __post_init__(self):
        self.history: List[np.ndarray] = []

    def record_step(self, times: Sequence[float]):
        assert len(times) == self.num_workers
        self.history.append(np.asarray(times, np.float64))
        if len(self.history) > self.window:
            self.history.pop(0)

    def stragglers(self) -> List[int]:
        if not self.history:
            return []
        mean_t = np.mean(np.stack(self.history), axis=0)
        med = float(np.median(mean_t))
        return [int(w) for w in np.flatnonzero(mean_t > self.threshold * med)]

    def hedge_plan(self, pending_arms: Sequence[int], slow_arm: int) -> List[int]:
        """Serving-side: reorder so the slow arm is polled last (its answer
        is most likely to be early-stopped away)."""
        plan = [a for a in pending_arms if a != slow_arm]
        if slow_arm in pending_arms:
            plan.append(slow_arm)
        return plan


# ---------------------------------------------------------------------------
# Arm-level fault injection for the serving plane.
#
# Faults are drawn from a counter-based hash keyed on
# (seed, epoch, arm, wave slot, batch row) — no RNG object, no hidden state.
# That determinism is load-bearing: the device and reference data planes
# must observe the *same* fault schedule for the bit-equivalence pin to
# extend to faulted runs, and a re-run of the same batch must fault identically so the
# failover tests are reproducible. Time only advances when the caller calls
# :meth:`FaultPolicy.advance` (e.g. once per served batch in a chaos bench);
# the router never advances it.
# ---------------------------------------------------------------------------

FAULT_OK = 0
FAULT_TIMEOUT = 1
FAULT_ERROR = 2
FAULT_DEGRADE = 3

#: virtual wave index used when hashing probe-traffic fault draws, chosen
#: far above any real plan length so probes never collide with wave cells
PROBE_WAVE = 1 << 20


def _mix64(z: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer over uint64 arrays (vectorized, stateless)."""
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _hash_cells(seed: int, epoch: int, arms, waves, rows, salt: int) -> np.ndarray:
    """uint64 hash per (arm, wave, row) cell under (seed, epoch, salt)."""
    a = np.asarray(arms, np.uint64)
    w = np.asarray(waves, np.uint64)
    r = np.asarray(rows, np.uint64)
    with np.errstate(over="ignore"):      # uint64 wraparound IS the hash
        k = (
            np.uint64(seed) * np.uint64(0x9E3779B97F4A7C15)
            ^ np.uint64(epoch) * np.uint64(0xC2B2AE3D27D4EB4F)
            ^ np.uint64(salt) * np.uint64(0x165667B19E3779F9)
        )
        z = k ^ (a * np.uint64(0xFF51AFD7ED558CCD))
        z ^= w * np.uint64(0xC4CEB9FE1A85EC53)
        z ^= r * np.uint64(0x2545F4914F6CDD1D)
        return _mix64(z)


def _uniform(h: np.ndarray) -> np.ndarray:
    """Map uint64 hashes to f64 uniforms in [0, 1)."""
    return (h >> np.uint64(11)).astype(np.float64) * (2.0**-53)


@dataclasses.dataclass
class ArmFaultSpec:
    """Per-arm fault rates; each invocation draws one of the outcomes.

    ``timeout`` and ``error`` both mean no usable response (they differ only
    in how they are tallied); ``degrade`` means the arm answers, but with a
    hash-drawn class instead of its real prediction (silent degradation).
    """

    timeout: float = 0.0
    error: float = 0.0
    degrade: float = 0.0

    def __post_init__(self):
        for name in ("timeout", "error", "degrade"):
            v = float(getattr(self, name))
            if not 0.0 <= v <= 1.0:
                raise ValueError(f"{name} rate must be in [0, 1], got {v}")
            setattr(self, name, v)
        if self.timeout + self.error + self.degrade > 1.0 + 1e-12:
            raise ValueError("fault rates must sum to <= 1")


class FaultPolicy:
    """Deterministic per-arm fault schedules for a :class:`PoolEngine`.

    ``grid_codes`` evaluates the whole (T, B) wave schedule in one
    vectorized pass and is the single authority both data planes consume —
    computing it once on the host is what keeps the planes bit-identical
    under faults. ``corrupt_grid`` is response-independent
    (pure hash of the cell), so silent degradation can be applied to the
    jit plane's speculative response grid and to the reference plane's live
    invocations without any cross-plane coordination.
    """

    def __init__(self, num_arms: int, num_classes: int, seed: int = 0):
        self.num_arms = int(num_arms)
        self.num_classes = int(num_classes)
        self.seed = int(seed)
        self.epoch = 0
        self._timeout = np.zeros(self.num_arms, np.float64)
        self._error = np.zeros(self.num_arms, np.float64)
        self._degrade = np.zeros(self.num_arms, np.float64)

    # -- configuration ------------------------------------------------------
    def set_arm(self, arm: int, *, timeout: float = 0.0, error: float = 0.0,
                degrade: float = 0.0) -> "FaultPolicy":
        spec = ArmFaultSpec(timeout=timeout, error=error, degrade=degrade)
        self._timeout[arm] = spec.timeout
        self._error[arm] = spec.error
        self._degrade[arm] = spec.degrade
        return self

    def set_arms(self, arms: Sequence[int], **rates) -> "FaultPolicy":
        for a in arms:
            self.set_arm(int(a), **rates)
        return self

    def clear(self, arm: Optional[int] = None) -> "FaultPolicy":
        sel = slice(None) if arm is None else arm
        self._timeout[sel] = 0.0
        self._error[sel] = 0.0
        self._degrade[sel] = 0.0
        return self

    def advance(self, n: int = 1) -> "FaultPolicy":
        """Move to a new fault epoch: fresh draws for the same cells."""
        self.epoch += int(n)
        return self

    @property
    def active(self) -> bool:
        return bool((self._timeout + self._error + self._degrade > 0.0).any())

    def spec(self, arm: int) -> ArmFaultSpec:
        return ArmFaultSpec(
            timeout=float(self._timeout[arm]),
            error=float(self._error[arm]),
            degrade=float(self._degrade[arm]),
        )

    # -- draws --------------------------------------------------------------
    def _codes(self, arms: np.ndarray, waves, rows) -> np.ndarray:
        """Fault code per cell; arms < 0 (padding) always draw OK."""
        safe = np.maximum(arms, 0)
        u = _uniform(_hash_cells(self.seed, self.epoch, safe, waves, rows, 1))
        t = self._timeout[safe]
        e = self._error[safe]
        d = self._degrade[safe]
        codes = np.zeros(arms.shape, np.int8)
        codes[u < t + e + d] = FAULT_DEGRADE
        codes[u < t + e] = FAULT_ERROR
        codes[u < t] = FAULT_TIMEOUT
        codes[arms < 0] = FAULT_OK
        return codes

    def grid_codes(self, sched_T: np.ndarray, row_offset: int = 0) -> np.ndarray:
        """(T, B) fault codes for a wave schedule (arm ids, -1 = no wave).

        ``row_offset`` shifts the batch-row coordinate of every cell: a
        worker dispatching rows ``[lo, lo+B)`` of a logically fused batch
        passes ``row_offset=lo`` so its draws are bit-identical to the same
        rows' draws in the single fused dispatch (the overlapped/fused
        placement equivalence contract of the replica plane).
        """
        T, B = sched_T.shape
        waves = np.broadcast_to(np.arange(T, dtype=np.int64)[:, None], (T, B))
        rows = np.broadcast_to(
            (np.arange(B, dtype=np.int64) + int(row_offset))[None, :], (T, B)
        )
        return self._codes(sched_T, waves, rows)

    def row_codes(self, arm_ids: np.ndarray, rows: np.ndarray,
                  wave: int = PROBE_WAVE) -> np.ndarray:
        """Fault codes for a flat (arm, row) list (probe traffic)."""
        arm_ids = np.asarray(arm_ids, np.int64)
        return self._codes(arm_ids, np.full(arm_ids.shape, wave, np.int64),
                           np.asarray(rows, np.int64))

    def corrupt_grid(self, sched_T: np.ndarray, row_offset: int = 0) -> np.ndarray:
        """(T, B) hash-drawn class per cell — the degraded 'response'.

        Response-independent by design: both planes can overwrite a
        degraded cell with the same class without knowing what the arm
        would have said. ``row_offset`` shifts batch-row coordinates the
        same way :meth:`grid_codes` does.
        """
        T, B = sched_T.shape
        safe = np.maximum(sched_T, 0)
        waves = np.broadcast_to(np.arange(T, dtype=np.int64)[:, None], (T, B))
        rows = np.broadcast_to(
            (np.arange(B, dtype=np.int64) + int(row_offset))[None, :], (T, B)
        )
        h = _hash_cells(self.seed, self.epoch, safe, waves, rows, 2)
        return (h % np.uint64(self.num_classes)).astype(np.int64)

    def corrupt_rows(self, arm_ids: np.ndarray, rows: np.ndarray,
                     wave: int = PROBE_WAVE) -> np.ndarray:
        arm_ids = np.asarray(arm_ids, np.int64)
        h = _hash_cells(self.seed, self.epoch, np.maximum(arm_ids, 0),
                        np.full(arm_ids.shape, wave, np.int64),
                        np.asarray(rows, np.int64), 2)
        return (h % np.uint64(self.num_classes)).astype(np.int64)


def failover_gather(
    sched_T: np.ndarray, failed: np.ndarray
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Compaction gather implementing in-wave failover.

    Given the plan-order wave schedule ``sched_T`` (T, B) and a boolean
    ``failed`` mask over it, slot ``u`` of each query's wave program serves
    the plan's ``u``-th *available* arm (scheduled and not failed) — i.e. a
    failed arm's slot re-routes to the plan's next-best arm. SurGreedy
    orders the plan by marginal gain per cost under the budget, so "next in
    plan order" is exactly "next-best affordable".

    Returns ``(src, valid, rank, navail)``:
      * ``src``    (T, B) int32 — original wave index serving slot u
        (0 where invalid; masked by ``valid``),
      * ``valid``  (T, B) bool — slot u has an available arm,
      * ``rank``   (T, B) int64 — failover slot each original cell would
        occupy (cumulative count of available cells above it),
      * ``navail`` (B,) int64 — available arms per query.

    With no failures this is the identity gather (``src[t] == t``,
    ``valid == sched_T >= 0``) — the wave program's failover mask is a
    provable no-op on fault-free traffic.
    """
    T, B = sched_T.shape
    avail = (sched_T >= 0) & ~failed
    rank = np.cumsum(avail, axis=0, dtype=np.int64) - avail
    src = np.zeros((T, B), np.int32)
    valid = np.zeros((T, B), bool)
    tt, bb = np.nonzero(avail)
    src[rank[tt, bb], bb] = tt.astype(np.int32)
    valid[rank[tt, bb], bb] = True
    return src, valid, rank, avail.sum(axis=0)


def attempted_failures(
    failed: np.ndarray,
    sched_T: np.ndarray,
    stop_wave: np.ndarray,
    rank: Optional[np.ndarray] = None,
    navail: Optional[np.ndarray] = None,
) -> np.ndarray:
    """(T, B) mask of failed cells the wavefront actually attempted.

    With failover (``rank``/``navail`` given), a failed cell was attempted
    iff its failover slot lies inside the effective stop: the wave program
    reached that position in plan order before Prop. 4 stopped (strictly
    before, except when the query exhausted every available arm — then the
    failures past the last served slot were attempted too). Without
    failover (frozen plans), attempted simply means the failed cell's wave
    index precedes the positional stop.
    """
    hit = failed & (sched_T >= 0)
    if rank is None:
        T = sched_T.shape[0]
        return hit & (np.arange(T)[:, None] < stop_wave[None, :])
    reach = stop_wave + (stop_wave == navail)
    return hit & (rank < reach[None, :])


def observed_faults(
    codes: Optional[np.ndarray],
    sched_T: np.ndarray,
    stop_wave: np.ndarray,
    rank: Optional[np.ndarray] = None,
    navail: Optional[np.ndarray] = None,
) -> Optional[np.ndarray]:
    """(T, B) int8 fault codes at cells the route actually observed.

    Attempted timeout/error failures plus silently-degraded cells that were
    really served; everything else (including injected faults past the stop
    wave, which no one ever saw) reads ``FAULT_OK``.
    """
    if codes is None:
        return None
    failed = (codes == FAULT_TIMEOUT) | (codes == FAULT_ERROR)
    attempted = attempted_failures(failed, sched_T, stop_wave, rank, navail)
    degrade = (codes == FAULT_DEGRADE) & (sched_T >= 0)
    if rank is None:
        T = sched_T.shape[0]
        served = degrade & (np.arange(T)[:, None] < stop_wave[None, :])
    else:
        served = degrade & (rank < stop_wave[None, :])
    return np.where(attempted | served, codes, FAULT_OK).astype(np.int8)
