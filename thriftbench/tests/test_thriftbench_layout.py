"""``BENCHMARK.json`` keeps to its contract, every name in it has its files,
and a configuration, mix, cell and metric added as files are found by name."""
import json
import re
from pathlib import Path

import numpy as np
import pytest

from thriftbench.spec import Cell, load_reader
from thriftbench.tests import tiny
from thriftbench.traffic import generate as gen

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["thriftbench"]
    assert BENCH["command"][1] == "thriftbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024
    cells = len(BENCH["workloads"])
    assert 2 + 14 * cells <= 2 + 14 * 24
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and (REPO / c["file"]).is_file()
        assert c["file"].startswith("thriftbench/") and 1 <= len(c["source"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in SOURCES and "\n" not in m["layer"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")


def test_every_cell_reports_what_it_must():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in BENCH["workloads"]:
        mine = [m["name"] for m in BENCH["end_to_end"] if w["name"] in m.get("workloads", [w["name"]])]
        assert "setup_s" in mine and len(mine) >= 2
        layer = [m for m in BENCH["per_layer"] if w["name"] in m.get("workloads", [w["name"]])]
        assert layer
        for m in layer:       # a metric's cells report the end-to-end metric it moves
            assert m["moves"] in mine


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_files(cell):
    c = Cell(REPO, cell)
    arms = [a["arch"] for a in c.config["arms"]]
    for a in c.config["arms"]:
        assert a["price_usd"] > 0 and a["model"]["dtype"] == "bfloat16"
    assert c.config["reduced"] == []
    limits = c.cell["limits"]
    for name in ("unfinished", "plan_mismatch", "agg_mismatch", "cost_mismatch"):
        assert limits[name] == 0
    for a in arms:       # each arm is judged by its widest gap or another number
        assert any(0 < limits.get(f"{n}.{a}", 0) for n in ("gap", "mean", "miss"))
    for m in c.per_layer():
        assert callable(c.reader(m["name"]))
    assert gen.arrivals(c.mix).ahead(c, 1, "window", 1.0) > 0


def test_every_metric_file_is_a_metric_and_back():
    readers = {p.stem for p in (REPO / "thriftbench" / "metrics").glob("*.py")
               if not p.stem.startswith("_") and p.stem != "arith"}
    assert readers == {m["name"] for m in BENCH["per_layer"]}


def test_added_files_are_found_by_name(tmp_path):
    root = tiny.checkout(tmp_path)
    metric = root / "thriftbench" / "metrics" / "extra.rows_seen.py"
    metric.write_text("def read(ctx):\n    return 7.0\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["per_layer"].append({"name": "extra.rows_seen", "unit": "rows", "better": "higher",
                               "source": "program_counter", "layer": "serving.scheduler",
                               "moves": "queries_per_s", "workloads": ["tiny.backlog"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    c = Cell(root, "tiny.backlog")
    assert c.config["name"] == "tiny-pool" and c.mix["arrivals"] == "backlog"
    assert c.cell["scheduler"]["max_batch"] == 16
    assert "extra.rows_seen" in [m["name"] for m in c.per_layer()]
    assert c.reader("extra.rows_seen")({}) == 7.0
    assert load_reader(metric)({}) == 7.0
    with pytest.raises(KeyError):
        Cell(root, "tiny.absent")


STEADY = '''"""A closed loop for a test: one block at a time, drained before the next."""
import time

import numpy as np


def ahead(cell, seed, stream, seconds):
    return 4 * int(cell.mix["block"])


def drive(feed, cell, seed, stream, seconds):
    t0 = time.monotonic()
    while time.monotonic() < t0 + seconds:
        feed.submit(int(cell.mix["block"]))
        feed.drain()
    t1 = time.monotonic()
    done = np.flatnonzero(~np.isnan(feed.done_at))
    return {"t0": t0, "t1": t1, "window_s": t1 - t0, "completed": done,
            "attempted": np.flatnonzero(~np.isnan(feed.submitted_at)),
            "end_to_end": {"queries_per_s": done.size / (t1 - t0)}}
'''


def test_added_arrival_law_and_budget_kind_are_found_by_name(tmp_path, monkeypatch):
    """A mix with an arrival law and a budget kind of its own, each added as
    a file, runs through the harness and its check untouched."""
    import time

    import torch

    from thriftbench.harness import run

    root = tiny.checkout(tmp_path, arms=("tiny-gqa", "tiny-window"))
    traffic = root / "thriftbench" / "traffic"
    (traffic / "arrivals" / "steady.py").write_text(STEADY)
    (traffic / "budgets" / "half.py").write_text(
        "import numpy as np\n\n\ndef levels(prices, spec):\n"
        "    return np.asarray([prices.sum() / 2])\n")
    (traffic / "tiny-steady.json").write_text(json.dumps(
        {"arrivals": "steady", "seq_len": 24, "vocab": 512, "budget": {"kind": "half"},
         "block": 8}))
    workloads = root / "thriftbench" / "workloads"
    (workloads / "tiny.steady.json").write_text((workloads / "tiny.backlog.json").read_text())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "tiny.steady", "config": "tiny-pool",
                               "traffic": "tiny-steady", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("tiny.steady")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(gen, "HERE", traffic)
    c = Cell(root, "tiny.steady")
    prices = np.asarray([a["price_usd"] for a in c.config["arms"]])
    np.testing.assert_allclose(gen.budget_levels(c.config, c.mix), [prices.sum() / 2])
    assert gen.arrivals(c.mix).ahead(c, 1, "window", 1.0) == 32
    torch.set_num_threads(1)
    res = run(root, "tiny.steady", 2**31 + 5, 0.5, False, "cpu", time.monotonic(), lambda m: None)
    assert res["correct"], res["checks"]
    assert res["metrics"]["queries_per_s"]["value"] > 0 and res["attempted"] > 0
    with pytest.raises(ValueError):
        gen.law("arrivals", "absent")
