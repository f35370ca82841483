"""Operations and bytes of the work the benchmark's cells need, and the
card's peaks: the yardstick of ``mfu`` and the kernel rooflines.

Counts are of what the inputs need, from shapes alone, 2 operations a
multiply-add, and each lives in a file found by name:

* ``thriftbench/blocks/<type>.py``: one layer's ``flops`` for a query of S
  prompt positions (every product at every position, a MoE token through
  its k experts only, attention over the visible pairs only) and its
  kernel ``launches``; a forward adds the vocabulary head at the answer
  position only;
* ``thriftbench/rooflines/<kernel>.py``: the ``bound`` of one launch, the
  larger of its operations at a peak and its bytes, each input read once
  and each output written once, at the HBM rate.

Peaks: NVIDIA H100 SXM data sheet, dense, at its 700 W limit.
"""
from __future__ import annotations

import pkgutil
from collections import Counter
from typing import Dict, List

import thriftbench.rooflines
from thriftbench.weights import derived, find_module, load_block

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12          # outside the tensor cores
PEAK_HBM_BYTES = 3.35e12
BF16, F32 = 2, 4


def visible_pairs(S: int, window: int) -> int:
    """(query, key) pairs a causal attention of S positions needs."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return sum(min(i + 1, window) for i in range(S))


def load_kernel(name: str):
    """The module of ``rooflines/<name>.py``: the kernel's launch counter,
    its profiler row and the bound of one launch."""
    return find_module("thriftbench.rooflines", name, "kernel")


def kernel_names() -> List[str]:
    """Every kernel with a file under ``rooflines/``."""
    return sorted({m.name for m in pkgutil.iter_modules(thriftbench.rooflines.__path__)
                   if not m.name.startswith("_")})


def forward_flops(model: Dict, S: int) -> float:
    """Operations one query of S prompt positions needs through the arm: each
    layer's block file's ``flops``, and the head at the answer position."""
    m = derived(model)
    total = 0.0
    for btype in m["layer_types"]:
        total += load_block(btype).flops(m, S)
    return total + 2 * m["d_model"] * m["vocab_size"]


def launches(model: Dict) -> Dict[str, int]:
    """Launches of each kernel in one forward of the arm, by its block files."""
    m = derived(model)
    out: Dict[str, int] = Counter()
    for btype, n in Counter(m["layer_types"]).items():
        for kernel, k in load_block(btype).launches(m).items():
            out[kernel] += n * k
    return dict(out)


def attention_layers(model: Dict) -> int:
    return launches(model).get("flash_attention", 0)


def ssm_layers(model: Dict) -> int:
    return launches(model).get("mamba_scan", 0)


def flash_launch(model: Dict, B: int, S: int) -> Dict[str, float]:
    return load_kernel("flash_attention").bound(derived(model), "attn", B, S)


def mamba_launch(model: Dict, B: int, S: int) -> Dict[str, float]:
    return load_kernel("mamba_scan").bound(derived(model), "ssm", B, S)


def roofline_bound(ops: float, nbytes: float, peak: float) -> Dict[str, float]:
    """The least time of ``ops`` operations at ``peak`` and ``nbytes`` bytes at
    the HBM rate, and which of the two bounds it."""
    t_ops, t_bytes = ops / peak, nbytes / PEAK_HBM_BYTES
    return {"ops": ops, "bytes": nbytes, "bound_s": max(t_ops, t_bytes),
            "term": "operations" if t_ops >= t_bytes else "bytes"}
