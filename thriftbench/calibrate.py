"""Readings the limits of ``correct`` are set from, and the knee of an open
loop; run on the card, never by the benchmark's own runs.

    python3 thriftbench/calibrate.py --workload <cell> --seeds 11,12,13 [--seconds 4]
        [--control fp8] [--arms ARM,...] [--rate QPS]
    python3 thriftbench/calibrate.py --workload <cell> --seeds 11 --rates 40,60,80 --seconds 15

For each seed, in one process: the cell's program drawn from the seed, a
short window of the cell's own traffic, the program freed, then every
number of :mod:`thriftbench.reference.check` — the forward gaps of the
program's answers and, with ``--control``, of the reference computed in
that lower precision on the same sampled rows, its answers then put through
the run's own comparison in the program's place: the command fails where
the control comes out correct on any seed. With ``--rates``: the
completed rate, the queue left and the latency quartiles of a window at
each offered rate (the knee sweep). One JSON line per reading on standard
output.
"""
from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import numpy as np  # noqa: E402
import torch  # noqa: E402

from thriftbench import harness  # noqa: E402
from thriftbench.reference import check  # noqa: E402
from thriftbench.spec import Cell  # noqa: E402


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def reading(cell: Cell, seed: int, seconds: float, control: str, dev, arms=None) -> bool:
    """One seed's readings; with a ``control``, its answers put through the
    run's own comparison in the program's place. False where the control
    passes it."""
    t0 = time.monotonic()
    prog = harness.build(cell, seed, dev, False, log)
    harness.warm_up(prog, cell, seed)
    win = harness.drive(prog, cell, seed, "window", seconds, False)
    harness.sync(prog)
    served = check.collect(prog, win)
    del prog
    win.pop("feed")
    gc.collect()
    torch.cuda.empty_cache()
    base = check.served_numbers(cell, seed, served, win)
    t1 = time.monotonic()
    picks = check.sample_rows(cell, served, seed)
    if arms:
        picks = {a: i for a, i in picks.items() if cell.config["arms"][a]["arch"] in arms}
    fwd = check.forward_gaps(cell, seed, served, dev, precision=control, picks=picks, log=log)
    out = {"cell": cell.name, "seed": seed, "control": control, "gaps": fwd, "counts": base,
           "routed": sum(r["qids"].size for r in served["routes"]),
           "program_s": t1 - t0, "reference_s": time.monotonic() - t1}
    judged = check.beside_limits(cell, {**base, **check.arm_numbers(cell, fwd, "program", log)})
    out["program_correct"] = check.passes(judged)
    if control != "f32":
        ctrl = check.beside_limits(cell, {**base, **check.arm_numbers(cell, fwd, "control", log)})
        out["control_correct"] = check.passes(ctrl)
        out["control_checks"] = ctrl
        log(f"seed {seed}: the {control} control in the program's place reads correct="
            f"{out['control_correct']}: " + ", ".join(
                f"{k} {v['value']} (limit {v['limit']})" for k, v in ctrl.items()))
    emit(out)
    return not out.get("control_correct", False)


def sweep(cell: Cell, seed: int, seconds: float, rates, dev) -> None:
    prog = harness.build(cell, seed, dev, False, log)
    harness.warm_up(prog, cell, seed)
    for rate in rates:
        cell.mix["rate_qps"] = rate
        win = harness.drive(prog, cell, seed, "window", seconds, False)
        lat = np.sort(win["latency_s"])
        n = lat.size
        thirds = [float(np.median(part)) for part in np.array_split(win["latency_s"], 3)]
        done = win["completed"].size
        emit({"cell": cell.name, "rate_qps": rate, "offered": int(n), "completed": int(done),
              "completed_per_s": done / seconds, "p50_ms": 1e3 * float(lat[n // 2]),
              "p95_ms": 1e3 * float(lat[max(0, int(np.ceil(0.95 * n)) - 1)]),
              "median_ms_by_third": [1e3 * t for t in thirds],
              "late_p95_ms": 1e3 * float(np.quantile(win["late_s"], 0.95)),
              "rows_per_group": prog["sched"].stats["completed"] / max(1, prog["sched"].stats["batches"])})
        prog["calls"].clear()
        prog["routes"].clear()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--control", default="f32")
    ap.add_argument("--rates", default=None)
    ap.add_argument("--rate", type=float, default=None)
    ap.add_argument("--arms", default=None, help="comma-separated arms whose gaps to read")
    args = ap.parse_args()
    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    cell = Cell(ROOT, args.workload)
    if args.rate:
        cell.mix["rate_qps"] = args.rate
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.rates:
        sweep(cell, seeds[0], args.seconds, [float(r) for r in args.rates.split(",")], dev)
        return 0
    failed = [seed for seed in seeds
              if not reading(cell, seed, args.seconds, args.control, dev,
                             args.arms.split(",") if args.arms else None)]
    if failed:
        log(f"the {args.control} control passed the comparison on seeds {failed}")
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
