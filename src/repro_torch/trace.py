"""Program spans of the front door: a process-wide ring of host span records
on ``time.monotonic()``, put on the profiler's timeline while it records.

    with trace.span("router.finalize", cells_invoked=n) as counts:
        ...
        counts["cells_used"] = m           # counts may be filled before the close
    with trace.mark("arm.moe.route"):      # a span under the profiler only
        ...

Each :func:`span` appends on its close one record to a ring of the newest
:data:`RING` records (:func:`spans`)::

    (seq, name, group, parent_seq, t0, t1, counts)

``seq`` numbers spans in the order they open; ``parent_seq`` is the ``seq``
of the enclosing span, -1 at the top; ``group`` is the budget group the
scheduler last named (:func:`new_group` at dispatch, :func:`set_group` at
retire; -1 before any), read at the close; ``t0``/``t1`` are
``time.monotonic()`` seconds; ``counts`` is the span's keyword dict. One
stack serves the process: no path of the port opens spans from more than
one thread.

While the profiler records (``torch._C._autograd._profiler_enabled()``),
``span`` and ``mark`` also open a profiler range of their name, so the span
lies on the kineto timeline beside the device rows: the C++
``RecordFunctionFast`` where this torch has it (~1.7 us a range under the
profiler on a CPU, against ~15 us for ``torch.profiler.record_function``),
else ``record_function``. Otherwise neither opens one: a flag check in its
place, against ~10 us a ``record_function`` costs with the profiler off.
:func:`mark` writes no record; it is for spans that run once per model
layer.

Every name starts with one of :data:`PREFIXES`. A profiler range also shows
on the device timeline as a user annotation covering its kernels; readers
of the device rows (``thriftbench/profile.py``, ``chip_smoke.py``) drop
those by these prefixes and would count any other name as a busy device
operation. Names are built once: constants at the call sites, an arm's at
its construction.
"""
from __future__ import annotations

import collections
import itertools
import time
from contextlib import nullcontext
from typing import Callable, Dict, List, Tuple

import torch

RING = 1 << 16
PREFIXES = ("arm.", "router.", "scheduler.", "traffic.")

Record = Tuple[int, str, int, int, float, float, Dict]

_ring: collections.deque = collections.deque(maxlen=RING)
_seq = itertools.count()
_groups = itertools.count()
_stack: List[int] = []           # seq of each open span, innermost last
_group = -1
_profiling = torch._C._autograd._profiler_enabled
_range = (getattr(torch._C._profiler, "_RecordFunctionFast", None)
          or torch.profiler.record_function)
_now = time.monotonic
_NULL = nullcontext()
_on_start: List[Callable[[], None]] = []    # called as the profiler starts recording


class span:
    """A ring span of ``name`` (see the module docstring); entering it
    returns its ``counts`` dict."""

    __slots__ = ("name", "counts", "_seq", "_parent", "_t0", "_rf")

    def __init__(self, name: str, **counts):
        self.name = name
        self.counts = counts

    def __enter__(self) -> Dict:
        self._seq = seq = next(_seq)
        self._parent = _stack[-1] if _stack else -1
        _stack.append(seq)
        if _profiling():
            self._rf = _range(self.name)
            self._rf.__enter__()
        else:
            self._rf = None
        self._t0 = _now()
        return self.counts

    def __exit__(self, *exc) -> bool:
        t1 = _now()
        if self._rf is not None:
            self._rf.__exit__(*exc)
        _stack.pop()
        _ring.append((self._seq, self.name, _group, self._parent, self._t0, t1, self.counts))
        return False


def mark(name: str):
    """A span that exists only under the profiler: a profiler range of
    ``name`` while it records, else a shared no-op context."""
    if _profiling():
        return _range(name)
    return _NULL


def recording() -> bool:
    """Whether the profiler records: what :func:`mark` opens a range on, and
    what the program's device-side counters count under."""
    return _profiling()


def on_recording_start(fn: Callable[[], None]) -> None:
    """Call ``fn()`` whenever the profiler starts recording: torch calls
    ``torch.autograd.profiler._run_on_profiler_start`` by name then, and
    that function is wrapped here once. Where a torch lacks it, ``fn`` is
    never called."""
    import torch.autograd.profiler as prof

    start = getattr(prof, "_run_on_profiler_start", None)
    if start is None:
        return
    if not _on_start:
        def started() -> None:
            start()
            for f in _on_start:
                f()

        prof._run_on_profiler_start = started
    _on_start.append(fn)


def new_group() -> int:
    """Number a newly dispatched budget group; spans closed from now on
    carry it."""
    global _group
    _group = next(_groups)
    return _group


def set_group(group: int) -> None:
    """Spans closed from now on carry ``group`` (a group being retired)."""
    global _group
    _group = group


def spans() -> List[Record]:
    """The ring's records, oldest first."""
    return list(_ring)


def reset() -> None:
    """Empty the ring."""
    _ring.clear()
