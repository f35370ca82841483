"""``mamba_scan``: 7 f32 operations a (t, d, n) — dt A, its exp, the decay,
dt x B, the update, C h and the sum — and 3 a (t, d) — dt x, D x and its
add — at the f32 peak outside the tensor cores; x, B, C read (bf16), dt, A
and D read (f32), y written (bf16) and the last state h written (f32), each
once."""
from typing import Dict

from thriftbench.metrics.arith import BF16, F32, PEAK_F32_FLOPS, roofline_bound

COUNTER = "mamba_scan"
ROW = "mamba_scan_kernel"


def bound(m: Dict, btype: str, B: int, S: int) -> Dict[str, float]:
    Din, N = m["d_inner"], m["ssm_state"]
    ops = float(B * S * Din * (7 * N + 3))
    nbytes = float(BF16 * B * S * (2 * Din + 2 * N) + F32 * B * S * Din
                   + F32 * (Din * N + Din) + F32 * B * Din * N)
    return roofline_bound(ops, nbytes, PEAK_F32_FLOPS)
