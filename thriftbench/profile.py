"""The traced slice: a ``torch.profiler`` trace of a stretch of the cell's own
traffic, and what the per-layer readers take from it.

A bare trace loses kernel rows at its ends, so the slice is begun after the
card is idle, bracketed by spin kernels (``torch.cuda._sleep``) before and
after, and ended by a synchronize inside the traced span; the spin rows are
left out. :func:`check_rows` then holds the kernel rows of the port's own
kernels against their launch counters over the slice.
"""
from __future__ import annotations

import time
from collections import defaultdict
from typing import Callable, Dict, List, Tuple

import torch

SLICE = "bench.slice"
HOST_SPANS = ("arm.", "router.", "scheduler.", "traffic.")
SPIN = "spin_kernel"
SENTINELS = 4
SPIN_CYCLES = 2000


def trace(fn: Callable[[], None]):
    """Run ``fn`` under the profiler; returns the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    time.sleep(0.05)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(SENTINELS):
            torch.cuda._sleep(SPIN_CYCLES)
        with record_function(SLICE):
            fn()
            torch.cuda.synchronize()
        for _ in range(SENTINELS):
            torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
    return prof


def short_name(name: str) -> str:
    """A kernel's name without its return type, arguments or template
    arguments past the first 96 characters."""
    name = name[5:] if name.startswith("void ") else name
    name = name.replace("(anonymous namespace)", "anon")
    return name.split("(")[0][:96]


def _events(prof):
    """(name, on the device, start us, end us) of every event of the trace,
    read from the profiler's raw results (building its event tree takes
    minutes for a slice of serving)."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() / 1e3
        out.append((e.name(), e.device_type() == DeviceType.CUDA, start,
                    start + e.duration_ns() / 1e3))
    return out


def parse(prof) -> Dict:
    """Device rows, busy and window seconds, the top device ops and the
    longest idle gaps by what the host was doing."""
    events = _events(prof)
    span = next((e for e in events if e[0] == SLICE and not e[1]), None)
    if span is None:
        raise RuntimeError("the trace holds no slice span")
    t0, t1 = span[2], span[3]
    # a host span also shows on the device timeline as a user annotation
    # covering its kernels: not an operation
    rows = [(name, s, e) for name, dev, s, e in events
            if dev and SPIN not in name and not name.startswith(HOST_SPANS) and name != SLICE]
    host = [(s, e, name) for name, dev, s, e in events
            if not dev and name.startswith(HOST_SPANS)]
    busy: List[Tuple[float, float]] = []
    for _, s, e in sorted(rows, key=lambda r: r[1]):
        s, e = max(s, t0), min(e, t1)
        if e <= s:
            continue
        if busy and s <= busy[-1][1]:
            busy[-1] = (busy[-1][0], max(busy[-1][1], e))
        else:
            busy.append((s, e))
    gaps = []
    edge = t0
    for s, e in busy + [(t1, t1)]:
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    by_op: Dict[str, float] = defaultdict(float)
    for name, s, e in rows:
        by_op[short_name(name)] += (e - s) * 1e-6
    # the host spans of one thread nest, so a sweep with a stack names the
    # innermost span open at each gap's midpoint
    marks = sorted([(s, 1, name) for s, _, name in host] + [(e, 0, name) for _, e, name in host]
                   + [(0.5 * (s + e), 2, (s, e)) for s, e in gaps], key=lambda m: (m[0], m[1]))
    idle = defaultdict(float)
    stack: List[str] = []
    for _, kind, what in marks:
        if kind == 1:
            stack.append(what)
        elif kind == 0:
            if what in stack:
                del stack[len(stack) - 1 - stack[::-1].index(what)]
        else:
            idle[stack[-1] if stack else "host"] += (what[1] - what[0]) * 1e-6
    return {
        "rows": rows,
        "busy_s": sum(e - s for s, e in busy) * 1e-6,
        "window_s": (t1 - t0) * 1e-6,
        "device_ops": sorted(([k, v] for k, v in by_op.items()), key=lambda kv: -kv[1])[:10],
        "idle_gaps": sorted(([k, v] for k, v in idle.items()), key=lambda kv: -kv[1])[:10],
    }


def kernel_rows(parsed: Dict, kernel: str) -> Tuple[int, float]:
    """(rows, device seconds) of the kernel whose entry point is ``kernel``."""
    hits = [(s, e) for name, s, e in parsed["rows"] if kernel in name]
    return len(hits), sum(e - s for s, e in hits) * 1e-6


def check_rows(parsed: Dict, launches: Dict[str, int]) -> List[str]:
    """Mismatches between the rows of each kernel entry point (a name
    fragment) and its launch-counter delta."""
    bad = []
    for kernel, n in launches.items():
        rows, _ = kernel_rows(parsed, kernel)
        if rows != n:
            bad.append(f"{kernel}: {rows} rows in the trace, {n} launches counted")
    return bad
