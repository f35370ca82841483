"""Helpers the readers share: the window's routes, invocations and rooflines."""
from __future__ import annotations

from collections import Counter
from typing import Dict, Optional

import numpy as np

from thriftbench import profile as tprof
from thriftbench.metrics import arith
from thriftbench.weights import derived, load_block


def rows_per_group(ctx: Dict) -> Optional[float]:
    s0, s1 = ctx["stats"]
    groups = s1["batches"] - s0["batches"]
    return None if groups <= 0 else (s1["completed"] - s0["completed"]) / groups


def window_routes(ctx: Dict):
    t0, t1 = ctx["window"]["t0"], ctx["window"]["t1"]
    return [r for r in ctx["served"]["routes"] if t0 <= r["t"] <= t1]


def idle_share(ctx: Dict) -> Optional[float]:
    sl = ctx["slice"]
    if sl is None or sl["window_s"] <= 0:
        return None
    return 1.0 - sl["busy_s"] / sl["window_s"]


def roofline(ctx: Dict, kernel: str) -> Optional[float]:
    """Sum of the kernel's bounds over the traced slice's launches, over the
    sum of its device time there, in %; the bounding term is logged. A
    launch's bound is the kernel file's (``thriftbench/rooflines/<kernel>.py``),
    and the launches of each arm call are its block files' ``launches``."""
    sl = ctx["slice"]
    if sl is None:
        return None
    kern = arith.load_kernel(kernel)
    n, device_s = tprof.kernel_rows(sl, kern.ROW)
    if n == 0 or device_s <= 0:
        return None
    seq = ctx["cell"].mix["seq_len"] - 1
    models: Dict[int, Dict] = {}
    bound, terms = 0.0, set()
    for arm, tokens, _, _, _ in sl["calls"]:
        if arm not in models:
            models[arm] = derived(ctx["pool"]["arms"][arm]["model"])
        m = models[arm]
        for btype, layers in Counter(m["layer_types"]).items():
            k = layers * load_block(btype).launches(m).get(kernel, 0)
            if k:
                b = kern.bound(m, btype, int(np.asarray(tokens).shape[0]), seq)
                bound += k * b["bound_s"]
                terms.add(b["term"])
    ctx["log"](f"{kernel}: {n} launches, {device_s} device s, bound {bound} s by "
               f"{'/'.join(sorted(terms))}")
    return 100.0 * bound / device_s


def flash(ctx: Dict) -> Optional[float]:
    return roofline(ctx, "flash_attention")


def mamba(ctx: Dict) -> Optional[float]:
    return roofline(ctx, "mamba_scan")
