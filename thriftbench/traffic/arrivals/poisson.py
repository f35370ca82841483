"""``{"arrivals": "poisson", "rate_qps": r, "lead_s": l}``: an open loop.
Arrivals are a Poisson process conditioned on its count: ``r`` times the
duration at sorted uniform times, over ``l`` seconds of lead-in and then
the window. Each query is submitted alone at its due time and timed from
then to when its future is seen done; ``latency_p95_ms`` is the
nearest-rank 95th percentile over every query due in the window, one never
done counting as waiting to ``WAIT_AFTER_CLOSE_S`` past the close."""
from __future__ import annotations

import math
import time
from typing import Dict

import numpy as np

WAIT_AFTER_CLOSE_S = 60.0


def offsets(mix: Dict, seed: int, duration: float, stream: str) -> np.ndarray:
    """Sorted arrival offsets (s) over ``[0, duration)``."""
    from thriftbench.traffic.generate import rng_for

    n = int(round(float(mix["rate_qps"]) * duration))
    rng = rng_for(seed, stream, 1)
    return np.sort(rng.uniform(0.0, duration, size=n))


def ahead(cell, seed: int, stream: str, seconds: float) -> int:
    return len(offsets(cell.mix, seed, float(cell.mix["lead_s"]) + seconds, stream))


def drive(feed, cell, seed: int, stream: str, seconds: float) -> Dict:
    lead_s = float(cell.mix["lead_s"])
    start = time.monotonic() + 0.01
    due = start + offsets(cell.mix, seed, lead_s + seconds, stream)
    t0, t1 = start + lead_s, start + lead_s + seconds
    counted = np.flatnonzero((due >= t0) & (due < t1))
    ids = np.empty(due.size, np.int64)
    late = np.zeros(due.size)
    i = 0
    while True:
        now = time.monotonic()
        while i < due.size and due[i] <= now:
            ids[i] = feed.submit(1, due=float(due[i]))[0]
            late[i] = now - due[i]
            i += 1
        feed.pump()
        if i >= due.size:
            if np.isfinite(feed.done_at[ids[counted]]).all():
                break
            if time.monotonic() > t1 + WAIT_AFTER_CLOSE_S:
                break
        wake = due[i] if i < due.size else math.inf
        nd = feed.sched.next_deadline()
        if nd is not None:
            wake = min(wake, nd)
        if not math.isfinite(wake):
            wake = time.monotonic() + 0.0005
        pause = wake - time.monotonic()
        if pause > 0:
            time.sleep(pause)
    feed.drain()
    q = ids[counted]
    lat = feed.done_at[q] - due[counted]
    lat = np.where(np.isnan(lat), t1 + WAIT_AFTER_CLOSE_S - due[counted], lat)
    ranked = np.sort(lat)
    p95 = float(ranked[max(0, math.ceil(0.95 * ranked.size) - 1)])
    late = late[counted]
    return {"t0": t0, "t1": t1, "window_s": seconds, "completed": q[np.isfinite(feed.done_at[q])],
            "attempted": q, "latency_s": lat, "late_s": late,
            "end_to_end": {"latency_p95_ms": 1e3 * p95},
            "notes": [f"generator lateness over {late.size} arrivals: p50 {np.median(late)} s, "
                      f"p95 {np.quantile(late, 0.95)} s, max {late.max()} s"] if late.size else []}
