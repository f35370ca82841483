"""Where each leaf of the port's per-layer trees lives in the JAX
package's stacked trees, for the tests that hold the two packages' specs
and shapes leaf by leaf. Imports neither package.

The port's layers run in the JAX order — segments, then repeats, then the
pattern unit — so layer ``i`` is repeat ``r`` of unit ``j`` of segment
``si``, and its leaf ``name`` is row ``r`` of JAX's ``seg<si>/u<j>/name``
(params) or ``segs[si]/u<j>/name`` (caches).
"""
from __future__ import annotations

from functools import reduce
from typing import Any, List, Optional, Tuple


def layer_slots(cfg) -> List[Tuple[int, int, int]]:
    """(segment, unit, repeat) of each of the port's layers, in its order."""
    out = []
    for si, (unit, repeats) in enumerate(cfg.segments()):
        for r in range(repeats):
            for j in range(len(unit)):
                out.append((si, j, r))
    return out


def param_path(name: str, cfg) -> Tuple[Tuple, Optional[int]]:
    """(path in the JAX parameter tree, stacked row or None) of the port's
    parameter ``name`` (an ``LM.named_parameters()`` name)."""
    if name == "tok":
        return ("embed", "tok"), None
    if name == "final_norm":
        return ("final_norm",), None
    if name == "head":
        return ("head", "w"), None
    _, i, _, leaf = name.split(".")
    si, j, r = layer_slots(cfg)[int(i)]
    return (f"seg{si}", f"u{j}", leaf), r


def cache_path(i: int, leaf: str, cfg) -> Tuple[Tuple, int]:
    """(path in the JAX cache, stacked row) of leaf ``leaf`` of layer ``i``."""
    si, j, r = layer_slots(cfg)[i]
    return ("segs", si, f"u{j}", leaf), r


def at(tree: Any, path: Tuple) -> Any:
    return reduce(lambda t, k: t[k], path, tree)
