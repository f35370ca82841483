"""A run of the harness, its look for a card skipped, with the timed path
broken underneath: ``correct`` has to come out false for each fault a
serving cell can have, and true with nothing broken. The fp8 control, put
in the program's place, fails the comparison on every seed tried."""
import time

import numpy as np
import pytest
import torch

from repro_torch.serving import BatchScheduler, LMArm
from thriftbench.harness import run
from thriftbench.reference import check
from thriftbench.spec import Cell
from thriftbench.tests import tiny

ARMS = ("tiny-gqa", "tiny-window")
SEED = 2**31 + 4242


@pytest.fixture(autouse=True)
def one_thread():
    """bf16 products on the CPU round by how they are split over threads:
    one thread keeps the tiny sound runs' gaps the same on every machine."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.checkout(tmp_path_factory.mktemp("faults"), arms=ARMS)


def one_run(root, cell="tiny.backlog", seed=SEED):
    torch.manual_seed(0)
    return run(root, cell, seed, 1.0, False, "cpu", time.monotonic(), lambda m: None)


def failing(res):
    return {k: v["value"] for k, v in res["checks"].items() if v["value"] > v["limit"]}


@pytest.mark.parametrize("cell", ["tiny.backlog", "tiny.poisson"])
def test_sound_program_is_correct(root, cell):
    res = one_run(root, cell)
    assert res["correct"], failing(res)
    assert res["failed"] == 0 and res["attempted"] > 0


def test_an_answer_altered_where_it_is_produced(root, monkeypatch):
    plain = LMArm.classify_batch

    def altered(self, tokens):
        return (plain(self, tokens) + 1) % 4

    monkeypatch.setattr(LMArm, "classify_batch", altered)
    res = one_run(root)
    assert not res["correct"]
    assert any(k.startswith("gap.") for k in failing(res))


def test_half_of_a_batch_left_out(root, monkeypatch):
    """An arm runs the first half of its rows and hands the second half the
    first half's answers."""
    plain = LMArm.classify_batch

    def half(self, tokens):
        tokens = np.asarray(tokens)
        n = (tokens.shape[0] + 1) // 2
        out = plain(self, tokens[:n])
        return np.resize(out, tokens.shape[0])

    monkeypatch.setattr(LMArm, "classify_batch", half)
    assert not one_run(root)["correct"]


def test_half_of_each_group_never_completed(root, monkeypatch):
    plain = BatchScheduler._resolve_rows

    def drop(self, group, rows, *args, **kwargs):
        keep = np.asarray(rows)[: (len(rows) + 1) // 2]
        args = [a[: keep.size] if isinstance(a, np.ndarray) and a.shape[:1] == (len(rows),) else a
                for a in args]
        return plain(self, group, keep, *args, **kwargs)

    monkeypatch.setattr(BatchScheduler, "_resolve_rows", drop)
    res = one_run(root)
    assert not res["correct"] and res["checks"]["unfinished"]["value"] > 0


def test_a_final_answer_altered(root, monkeypatch):
    """The aggregate a query's future reports is not the one its arms voted."""
    plain = BatchScheduler._resolve_rows

    def flip(self, group, rows, predictions, *args, **kwargs):
        return plain(self, group, rows, (np.asarray(predictions) + 1) % 4, *args, **kwargs)

    monkeypatch.setattr(BatchScheduler, "_resolve_rows", flip)
    res = one_run(root)
    assert not res["correct"] and res["checks"]["agg_mismatch"]["value"] > 0


@pytest.mark.parametrize("seed", [11, 12, 13])
def test_fp8_control_fails_where_the_program_passes(root, seed):
    """The reference in e4m3 in the program's place, on the calls a window
    made: its answers, put through the run's comparison in the program's
    place, fail it on every seed; the program's pass."""
    from thriftbench import harness

    cell = Cell(root, "tiny.backlog")
    cell.cell["check"]["rows_per_arm"] = 10**6       # every row the window served
    prog = harness.build(cell, seed, torch.device("cpu"), False, lambda m: None)
    harness.warm_up(prog, cell, seed)
    win = harness.drive(prog, cell, seed, "window", 1.0, False)
    served = check.collect(prog, win)
    del prog
    gaps = check.forward_gaps(cell, seed, served, torch.device("cpu"), precision="fp8")
    base = check.served_numbers(cell, seed, served, win)
    sound = check.beside_limits(cell, {**base, **check.arm_numbers(cell, gaps, "program", print)})
    control = check.beside_limits(cell, {**base, **check.arm_numbers(cell, gaps, "control", print)})
    assert check.passes(sound), sound
    assert not check.passes(control), control
