"""One run of one cell: set-up, the traced slice (``--trace 1``), the measured
window, the per-layer readings, and the check of what the window produced.

The program under test is the port's front door::

    BatchScheduler(ThriftRouter(PoolEngine([LMArm ...]), SuccessProbEstimator(...),
                                K, use_kernel=True, device=...))

fed by ``submit_many`` and driven by ``pump``. Around it the benchmark puts
two thin taps of its own: each arm is wrapped so that every
``classify_batch`` call is logged (its rows, its answers, its host span),
and the router is wrapped so that every ``begin_route`` is logged with the
calls it made. The check and the per-layer readers read those logs, the
scheduler's ``stats`` and the kernels' launch counters.
"""
from __future__ import annotations

import dataclasses
import gc
import time
from contextlib import nullcontext
from typing import Dict, List, Optional

import numpy as np
import torch

from thriftbench import profile as tprof
from thriftbench.metrics import arith
from thriftbench.reference import check as refcheck
from thriftbench.spec import Cell
from thriftbench.traffic import generate as gen
from thriftbench.weights import derived, draw_arm

# keys of an arm's model that are the benchmark's and not the program's;
# any other key is handed to ``ModelConfig``, which refuses one it lacks
OWN_KEYS = ("layer_types",)

CHUNK = 2048                   # queries a bank draws at a time
# kernel entry points no block file launches, and their launch counters
OTHER_KERNELS = {"rglru_scan_kernel": ("rglru_scan",),
                 "belief_aggregate_kernel": ("belief_aggregate",),
                 "mc_tie_hist": ("mc_correctness", "mc_correctness_grouped")}


def span(trace: bool, name: str):
    if not trace:
        return nullcontext()
    from torch.profiler import record_function
    return record_function(name)


class ArmTap:
    """An arm whose ``classify_batch`` calls are logged as
    ``(arm index, tokens, answers, t_start, t_end)``."""

    def __init__(self, arm, index: int, log: List, trace: bool):
        self._arm, self._index, self._log, self._trace = arm, index, log, trace

    def __getattr__(self, name):
        return getattr(self._arm, name)

    def classify_batch(self, tokens):
        t0 = time.monotonic()
        with span(self._trace, f"arm.{self._arm.name}"):
            out = self._arm.classify_batch(tokens)
        self._log.append((self._index, tokens, out, t0, time.monotonic()))
        return out


class RouterTap:
    """A router whose routes are logged as ``(t_begin, pending, first call,
    end call)``, the calls indexing the arms' log."""

    def __init__(self, router, calls: List, routes: List, trace: bool):
        self._router, self._calls, self._routes, self._trace = router, calls, routes, trace

    def __getattr__(self, name):
        return getattr(self._router, name)

    def begin_route(self, *args, **kwargs):
        t0, lo = time.monotonic(), len(self._calls)
        with span(self._trace, "router.begin_route"):
            pending = self._router.begin_route(*args, **kwargs)
        self._routes.append((t0, pending, lo, len(self._calls)))
        return pending


class Bank:
    """The queries of one stream, drawn from the seed a chunk at a time."""

    def __init__(self, pool: Dict, mix: Dict, seed: int, stream: str, n: int = CHUNK):
        self.pool, self.mix, self.seed, self.stream = pool, mix, seed, stream
        self.parts: Dict[str, List[np.ndarray]] = {}
        self.n = 0
        self.next = 0
        self._chunks = 0
        self.grow(n)

    def grow(self, n: int) -> None:
        q = gen.make_queries(self.pool, self.mix, self.seed, n, self.stream, sub=self._chunks)
        self._chunks += 1
        for k in ("tokens", "emb", "budgets", "clusters"):
            self.parts.setdefault(k, []).append(q[k])
            setattr(self, k, np.concatenate(self.parts[k]))
        self.n += n

    def take(self, n: int) -> np.ndarray:
        while self.next + n > self.n:
            self.grow(CHUNK)
        ids = np.arange(self.next, self.next + n)
        self.next += n
        return ids


class Feed:
    """Submissions and completions of one stretch of traffic."""

    def __init__(self, sched, bank: Bank, trace: bool):
        self.sched, self.bank, self.trace = sched, bank, trace
        self.blocks: List = []                  # pending: [ids, BlockFuture, rows seen done]
        self.every: List = []                   # every (ids, BlockFuture) submitted
        self.done_at = np.full(0, np.nan)
        self.due = np.full(0, np.nan)
        self.submitted_at = np.full(0, np.nan)

    def _room(self, upto: int) -> None:
        if self.done_at.size < upto:
            extra = max(upto - self.done_at.size, CHUNK)
            pad = np.full(extra, np.nan)
            self.done_at = np.concatenate([self.done_at, pad])
            self.due = np.concatenate([self.due, pad])
            self.submitted_at = np.concatenate([self.submitted_at, pad])

    def submit(self, n: int, due: Optional[float] = None) -> np.ndarray:
        b = self.bank
        ids = b.take(n)
        self._room(int(ids[-1]) + 1)
        now = time.monotonic()
        with span(self.trace, "traffic.submit"):
            blk = self.sched.submit_many(b.tokens[ids], b.emb[ids], b.budgets[ids],
                                         arrival_s=now if due is None else due)
        self.submitted_at[ids] = now
        self.due[ids] = now if due is None else due
        self.blocks.append([ids, blk, np.zeros(ids.size, bool)])
        self.every.append((ids, blk))
        return ids

    def pump(self) -> None:
        with span(self.trace, "scheduler.pump"):
            self.sched.pump()
        self.observe()

    def drain(self) -> None:
        with span(self.trace, "scheduler.drain"):
            self.sched.drain()
        self.observe()

    def observe(self) -> None:
        now = time.monotonic()
        keep = []
        for entry in self.blocks:
            ids, blk, seen = entry
            done = blk.predictions >= 0
            new = done & ~seen
            if new.any():
                self.done_at[ids[new]] = now
                entry[2] = done
            if not done.all():
                keep.append(entry)
        self.blocks = keep

    def queued(self) -> int:
        st = self.sched.stats
        return int(st["submitted"] - st["requests"])


def build(cell: Cell, seed: int, device: torch.device, trace: bool, log) -> Dict:
    """The program under test, its arms drawn from ``seed``, and its taps."""
    from repro_torch.core.estimation import SuccessProbEstimator
    from repro_torch.models import LM
    from repro_torch.models.config import ModelConfig
    from repro_torch.serving import BatchScheduler, LMArm, PoolEngine, ThriftRouter

    pool, mix = cell.config, cell.mix
    calls: List = []
    routes: List = []
    cls_ids = gen.make_queries(pool, mix, seed, 1, "warmup")["class_token_ids"]
    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    own = set(OWN_KEYS) - fields
    arms = []
    for i, arm in enumerate(pool["arms"]):
        model = {k: v for k, v in arm["model"].items() if k not in own}
        cfg = ModelConfig(**dict(model, block_pattern=tuple(model["block_pattern"])))
        want = derived(arm["model"])["layer_types"]
        if list(cfg.layer_types) != want:
            raise ValueError(f"{arm['arch']}: the program builds layers {list(cfg.layer_types)}, "
                             f"the benchmark draws and checks {want}")
        layout = draw_arm(arm["model"], seed, i, device)
        lm = LM(cfg, device=device, params=layout)
        arms.append(ArmTap(LMArm(arm["arch"], lm, cls_ids, tokens_per_query=mix["seq_len"]),
                           i, calls, trace))
    hist = gen.make_history(pool, mix)
    est = SuccessProbEstimator(hist["table"], hist["emb"], hist["clusters"])
    router = ThriftRouter(PoolEngine(arms), est, pool["num_classes"], use_kernel=True,
                          device=device)
    tap = RouterTap(router, calls, routes, trace)
    sched = BatchScheduler(tap, **cell.cell["scheduler"])
    log(f"program: {len(arms)} arms, "
        f"{sum(p.numel() for a in arms for p in a.model.parameters()) / 1e9:.3f} B params, "
        f"prices {[a.cost for a in arms]}")
    return {"sched": sched, "arms": arms, "calls": calls, "routes": routes,
            "history": hist, "cls_ids": cls_ids}


def warm_up(prog: Dict, cell: Cell, seed: int, mark=lambda name: None) -> None:
    """Every shape the cell's traffic uses, through the whole front door:
    plans for every (cluster, budget), a group of each budget through the
    scheduler, and each arm at the cell's extra batch sizes. ``mark(name)``
    is called as each part ends."""
    sched = prog["sched"]
    levels = gen.budget_levels(cell.config, cell.mix)
    sched.prewarm(budgets=[float(b) for b in levels])
    mark("plans")
    rows = int(cell.cell["warmup_rows"])
    extra = [int(n) for n in cell.cell.get("warmup_batches", [])]
    bank = Bank(cell.config, cell.mix, seed, "warmup", n=rows * levels.size + sum(extra) + 1)
    for b in levels:
        ids = bank.take(rows)
        sched.submit_many(bank.tokens[ids], bank.emb[ids], float(b))
        sched.drain()
    sync(prog)
    mark("groups")
    for n in extra:
        ids = bank.take(n)
        for arm in prog["arms"]:
            arm._arm.classify_batch(bank.tokens[ids])
    sync(prog)
    prog["calls"].clear()
    prog["routes"].clear()


def sync(prog: Dict) -> None:
    dev = prog["arms"][0].model.device
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bank_for(cell: Cell, seed: int, stream: str, seconds: float) -> Bank:
    """The queries ``seconds`` of the cell's traffic from ``stream`` take,
    drawn ahead as the mix's arrival law counts them (the bank draws more, a
    chunk at a time, should the program outrun it)."""
    n = gen.arrivals(cell.mix).ahead(cell, seed, stream, seconds)
    return Bank(cell.config, cell.mix, seed, stream, n=max(n, 1))


def drive(prog: Dict, cell: Cell, seed: int, stream: str, seconds: float, trace: bool,
          bank: Optional[Bank] = None) -> Dict:
    """``seconds`` of the cell's traffic from ``stream``, by the mix's
    arrival law (``thriftbench/traffic/arrivals/<law>.py``)."""
    if bank is None:
        bank = bank_for(cell, seed, stream, seconds)
    feed = Feed(prog["sched"], bank, trace)
    out = gen.arrivals(cell.mix).drive(feed, cell, seed, stream, seconds)
    out["feed"] = feed
    return out


def launch_counts() -> Dict[str, int]:
    """The launch counter of each kernel entry point (a profiler row's name
    fragment): every kernel under ``thriftbench/rooflines/``, and the
    kernels no block file launches."""
    from repro_torch.kernels import ops

    rows = dict(OTHER_KERNELS)
    for name in arith.kernel_names():
        kern = arith.load_kernel(name)
        rows[kern.ROW] = (kern.COUNTER,)
    return {row: sum(getattr(ops, c).launches for c in counters) for row, counters in rows.items()}


def launch_mismatches(cell: Cell, calls: List, delta: Dict[str, int]) -> List[str]:
    """Each kernel under ``thriftbench/rooflines/`` whose launches counted over
    a stretch differ from the sum of the block files' ``launches`` over the
    arm calls made in it."""
    per_arm = {i: arith.launches(a["model"]) for i, a in enumerate(cell.config["arms"])}
    bad = []
    for name in arith.kernel_names():
        expect = sum(per_arm[c[0]].get(name, 0) for c in calls)
        got = delta[arith.load_kernel(name).ROW]
        if expect != got:
            bad.append(f"{name}: {got} launches counted, {expect} by the arm calls in the slice")
    return bad


def traced_slice(prog: Dict, cell: Cell, seed: int, log) -> Dict:
    """The profiled stretch of the cell's traffic, its rows held to the
    launch counters and the counters to the arm calls; taken again once
    where they disagree."""
    seconds = float(cell.cell["profile_s"])
    for attempt in (1, 2):
        n_calls = len(prog["calls"])
        before = launch_counts()
        bank = bank_for(cell, seed, "profile", seconds)
        prof = tprof.trace(lambda: drive(prog, cell, seed, "profile", seconds, True, bank))
        delta = {k: v - before[k] for k, v in launch_counts().items()}
        parsed = tprof.parse(prof)
        calls = prog["calls"][n_calls:]
        bad = tprof.check_rows(parsed, delta) + launch_mismatches(cell, calls, delta)
        if not bad:
            parsed["calls"] = calls
            parsed["launches"] = delta
            return parsed
        log(f"traced slice {attempt}: profiler rows disagree with the launch counters: {bad}")
    raise RuntimeError("the profiler lost kernel rows in two traced slices: " + "; ".join(bad))


def run(root, name: str, seed: int, seconds: float, trace: bool, device: str,
        t_start: float, log) -> Dict:
    """One run of cell ``name``; returns the result line's object."""
    cell = Cell(root, name)
    marks = []

    def mark(part: str) -> None:
        marks.append((part, time.monotonic()))

    mark("imports")
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        torch.empty(1, device=dev)
    mark("device")
    import repro_torch.serving  # noqa: F401  (timed apart from the build)
    mark("program imports")
    prog = build(cell, seed, dev, trace, log)
    sync(prog)
    mark("weights and arms")
    warm_up(prog, cell, seed, mark)
    bank = bank_for(cell, seed, "window", seconds)
    mark("window queries")
    setup_s = time.monotonic() - t_start
    log(f"setup_s {setup_s}; parts (s): " + ", ".join(
        f"{part} {t - (marks[i - 1][1] if i else t_start)}" for i, (part, t) in enumerate(marks)))
    sliced = traced_slice(prog, cell, seed, log) if trace else None
    prog["calls"].clear()
    prog["routes"].clear()
    stats0 = dict(prog["sched"].stats)
    win = drive(prog, cell, seed, "window", seconds, trace, bank)
    stats1 = dict(prog["sched"].stats)
    sync(prog)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    for note in win.get("notes", []):
        log(note)
    served = refcheck.collect(prog, win)
    ctx = {"cell": cell, "window": win, "stats": (stats0, stats1), "served": served,
           "calls": [c for c in prog["calls"] if win["t0"] <= c[3] <= win["t1"]],
           "slice": sliced, "pool": cell.config, "log": log}
    metrics: Dict[str, Dict] = {}
    if trace:
        for m in cell.per_layer():
            value = cell.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        e2e = dict(win["end_to_end"], setup_s=setup_s)
        for m in cell.end_to_end():
            metrics[m["name"]] = {"value": float(e2e[m["name"]]), "unit": m["unit"]}
    del prog, ctx
    win.pop("feed")
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.monotonic()
    checks = refcheck.judge(cell, seed, served, win, dev, log)
    log(f"check {time.monotonic() - t_check} s after a {win['window_s']} s window")
    correct = refcheck.passes(checks)
    result = {"correct": bool(correct), "attempted": int(win["attempted"].size),
              "failed": int(served["failed"]), "metrics": metrics,
              "device": device_info(dev, peak, sliced)}
    if sliced is not None:
        result["breakdown"] = {"device_ops": sliced["device_ops"], "idle_gaps": sliced["idle_gaps"]}
    result["checks"] = checks
    return result


def device_info(dev: torch.device, peak: int, sliced: Optional[Dict]) -> Dict:
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
                "memory_peak_bytes": int(peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    if sliced is not None:
        info["busy_s"] = sliced["busy_s"]
        info["window_s"] = sliced["window_s"]
    return info
