"""``flash_attention``: 2 (q/k dim + v dim) operations a visible (query, key)
pair and query head, at the bf16 peak; q, k, v read once and o written once,
in bf16. The heads, head dims and window of a launch are its layer's: the
block file's ``flash_shape(m)``."""
from typing import Dict

from thriftbench.metrics.arith import BF16, PEAK_BF16_FLOPS, roofline_bound, visible_pairs
from thriftbench.weights import load_block

COUNTER = "flash_attention"
ROW = "flash_attention_kernel"


def bound(m: Dict, btype: str, B: int, S: int) -> Dict[str, float]:
    f = load_block(btype).flash_shape(m)
    H, G, dims = f["heads"], f["kv_heads"], f["qk_dim"] + f["v_dim"]
    ops = 2.0 * B * H * dims * visible_pairs(S, f["window"])
    nbytes = float(BF16 * B * S * (H + G) * dims)      # q and o by H heads, k and v by G
    return roofline_bound(ops, nbytes, PEAK_BF16_FLOPS)
