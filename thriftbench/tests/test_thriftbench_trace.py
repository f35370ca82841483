"""The readers of the program's own spans on a tiny run of the harness on the
CPU: each reads a finite value, the program's counts agree with the taps'
where both see the same routes, and a program without spans, or a ring
that lost part of the window, is told apart."""
import math
import sys

import pytest
import torch

from thriftbench import harness
from thriftbench.reference import check
from thriftbench.spec import Cell
from thriftbench.tests import tiny

SEED = 2**31 + 77
NEW = ("scheduler.queue_wait_ms", "router.cells_past_stop", "router.self_ms_per_group",
       "engine.arm_share")


@pytest.fixture(scope="module")
def ctx(tmp_path_factory):
    """The context the harness hands its readers, after a 1 s window."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        root = tiny.checkout(tmp_path_factory.mktemp("trace"), arms=("tiny-gqa", "tiny-moe"))
        cell = Cell(root, "tiny.backlog")
        prog = harness.build(cell, SEED, torch.device("cpu"), False, lambda m: None)
        harness.warm_up(prog, cell, SEED)
        stats0 = dict(prog["sched"].stats)
        win = harness.drive(prog, cell, SEED, "window", 1.0, False)
        served = check.collect(prog, win)
        return {"cell": cell, "window": win, "stats": (stats0, dict(prog["sched"].stats)),
                "served": served,
                "calls": [c for c in prog["calls"] if win["t0"] <= c[3] <= win["t1"]],
                "slice": None, "pool": cell.config, "log": lambda m: None}
    finally:
        torch.set_num_threads(before)


def read(ctx, name):
    return ctx["cell"].reader(name)(ctx)


@pytest.mark.parametrize("name", NEW)
def test_each_reader_reads_a_finite_value(ctx, name):
    assert name in [m["name"] for m in ctx["cell"].per_layer()]
    value = read(ctx, name)
    assert value is not None and math.isfinite(value) and value >= 0
    if name.startswith("engine.") or name == "router.cells_past_stop":
        assert value <= 1


def test_cells_past_stop_equal_the_taps_wasted_invocations(ctx):
    assert read(ctx, "router.cells_past_stop") == pytest.approx(
        read(ctx, "router.wasted_invocations"), abs=1e-12)


def test_arm_spans_lie_inside_the_taps_calls(ctx):
    arm, tap = read(ctx, "engine.arm_share"), read(ctx, "engine.forward_share")
    assert 0 < arm <= tap


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_spans_reads_nothing(ctx, name, monkeypatch):
    import repro_torch

    monkeypatch.setitem(sys.modules, "repro_torch.trace", None)
    monkeypatch.delattr(repro_torch, "trace")
    assert read(ctx, name) is None


def test_the_programs_span_prefixes_are_dropped_from_the_device_rows():
    from repro_torch import trace
    from thriftbench.profile import HOST_SPANS

    assert set(trace.PREFIXES) <= set(HOST_SPANS)


def test_a_ring_that_lost_the_windows_start_fails_loudly(ctx, monkeypatch):
    from repro_torch import trace

    late = [r for r in trace.spans() if r[4] > ctx["window"]["t0"]]
    monkeypatch.setattr(trace, "spans", lambda: late)
    with pytest.raises(RuntimeError, match="overflowed"):
        read(ctx, "engine.arm_share")
