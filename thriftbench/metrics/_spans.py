"""Helpers of the readers of the program's own spans (``repro_torch.trace``):
the ring's records, checked to cover the window, and sums over them."""
from __future__ import annotations

from typing import Callable, Dict, List, Optional, Tuple

# a record: (seq, name, group, parent_seq, t0, t1, counts)
NAME, GROUP, T0, T1, COUNTS = 1, 2, 4, 5, 6


def records(ctx: Dict) -> Optional[List[Tuple]]:
    """The ring's records; None where the program keeps none (one without
    ``repro_torch.trace``). Raises where the ring's oldest record opened
    after the window did: the ring overflowed and lost part of the window."""
    try:
        from repro_torch import trace
    except ImportError:
        return None
    recs = trace.spans()
    if not recs:
        return None
    if recs[0][T0] > ctx["window"]["t0"]:
        raise RuntimeError(f"the program's span ring ({trace.RING} records) overflowed: its "
                           f"oldest record opened {recs[0][T0] - ctx['window']['t0']} s "
                           f"after the window")
    return recs


def window(ctx: Dict) -> Tuple[float, float]:
    return ctx["window"]["t0"], ctx["window"]["t1"]


def opened(recs, t0: float, t1: float, name: str) -> List[Tuple]:
    """The records of ``name`` opened inside the window."""
    return [r for r in recs if r[NAME] == name and t0 <= r[T0] <= t1]


def seconds(recs, t0: float, t1: float, pick: Callable[[str], bool]) -> float:
    """Seconds the spans whose names ``pick`` takes lie inside the window,
    each clipped to it."""
    return sum(max(0.0, min(r[T1], t1) - max(r[T0], t0)) for r in recs if pick(r[NAME]))


def arm_span(part: str) -> Callable[[str], bool]:
    """Picks ``arm.<name>.<part>``."""
    tail = "." + part
    return lambda name: name.startswith("arm.") and name.endswith(tail)
