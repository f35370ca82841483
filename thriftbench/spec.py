"""Finds everything of a cell by name: its entry in ``BENCHMARK.json``, its
configuration, its traffic mix, its cell file and the readers of its
per-layer metrics. Nothing here names a particular cell, configuration,
mix or metric: a later change adds one by adding files.

    BENCHMARK.json                      the cells, the metrics, their bounds
    thriftbench/configs/<config>.json   the arm pool as it is run
    thriftbench/traffic/<mix>.json      the mix's parameters
    thriftbench/traffic/arrivals/<law>.py   the arrival law a mix names
    thriftbench/traffic/budgets/<kind>.py   the budget kind a mix names
    thriftbench/workloads/<cell>.json   scheduler settings, checks, limits
    thriftbench/metrics/<metric>.py     one reader of one per-layer metric

An architecture is added the same way. An arm's ``model`` names each
layer's block type (``layer_types``, or ``block_pattern`` cycled), and
each type and each kernel is a file:

    thriftbench/blocks/<type>.py        spec(m): the layer's tensors in draw
                                        order; residual_depth(m); forward(h,
                                        p, m, precision, segments): the plain
                                        reference layer; flops(m, S);
                                        launches(m): {kernel: launches};
                                        BATCH_COUPLED: whether a row's output
                                        depends on the other rows of its
                                        served batch (then the check samples
                                        the arm by whole calls); with flash
                                        launches, flash_shape(m)
    thriftbench/rooflines/<kernel>.py   COUNTER: its launch counter in
                                        ``repro_torch.kernels.ops``; ROW: its
                                        profiler row's name fragment;
                                        bound(m, btype, B, S): one launch's
                                        ops, bytes, bound_s and term

A kernel's roofline metric is then a reader of three lines that calls
``metrics._shared.roofline(ctx, "<kernel>")``.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent


class Cell:
    """One cell with everything it names, loaded from ``root``."""

    def __init__(self, root: Path, name: str):
        self.root = Path(root)
        bench = json.loads((self.root / "BENCHMARK.json").read_text())
        entries = {w["name"]: w for w in bench["workloads"]}
        if name not in entries:
            raise KeyError(f"no cell {name!r} in BENCHMARK.json; known: {sorted(entries)}")
        self.name = name
        self.entry = entries[name]
        self.bench = bench
        folder = self.root / "thriftbench"
        self.config = _json(folder / "configs" / f"{self.entry['config']}.json")
        self.mix = _json(folder / "traffic" / f"{self.entry['traffic']}.json")
        self.cell = _json(folder / "workloads" / f"{name}.json")
        self.metrics_dir = folder / "metrics"

    def end_to_end(self) -> List[Dict]:
        return [m for m in self.bench["end_to_end"] if self.name in m.get("workloads", [self.name])]

    def per_layer(self) -> List[Dict]:
        return [m for m in self.bench["per_layer"] if self.name in m.get("workloads", [self.name])]

    def reader(self, metric: str) -> Callable:
        """The ``read(ctx)`` function of ``metrics/<metric>.py``."""
        return load_reader(self.metrics_dir / f"{metric}.py")


def _json(path: Path) -> Dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def load_reader(path: Path) -> Callable:
    spec = importlib.util.spec_from_file_location(f"thriftbench_metric_{path.stem}", path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(f"no metric reader at {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read
