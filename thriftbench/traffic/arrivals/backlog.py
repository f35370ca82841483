"""``{"arrivals": "backlog", "block": b, "ahead_groups": g}``: a labelling
job. The queue is topped up with blocks of ``b`` queries to ``g`` groups of
the scheduler's ``max_batch`` before every pump. The window opens at the
first completion and closes at the first completion seen ``seconds``
later; ``queries_per_s`` counts what completed in between over that time."""
from __future__ import annotations

import time
from typing import Dict

import numpy as np


def ahead(cell, seed: int, stream: str, seconds: float) -> int:
    """Queries drawn before the stretch: the cell file's ``qps_ahead`` times
    its seconds, and four blocks more."""
    return int(float(cell.cell["qps_ahead"]) * seconds) + 4 * int(cell.mix["block"])


def drive(feed, cell, seed: int, stream: str, seconds: float) -> Dict:
    block, cap = int(cell.mix["block"]), int(cell.mix["ahead_groups"]) * feed.sched.max_batch
    t0 = None
    while True:
        while feed.queued() < cap:
            feed.submit(block)
        before = np.count_nonzero(~np.isnan(feed.done_at))
        feed.pump()
        now = time.monotonic()
        if np.count_nonzero(~np.isnan(feed.done_at)) > before:
            if t0 is None:
                t0 = now
            elif now >= t0 + seconds:
                t1 = now
                break
    closed_ids = np.flatnonzero(~np.isnan(feed.submitted_at))
    feed.drain()
    done = feed.done_at
    in_window = np.flatnonzero((done > t0) & (done <= t1))
    return {"t0": t0, "t1": t1, "window_s": t1 - t0, "completed": in_window,
            "attempted": closed_ids,
            "end_to_end": {"queries_per_s": in_window.size / (t1 - t0)}}
