"""``causal_conv1d``, the Mamba mixer's depthwise causal conv with its bias
and SiLU: the x half of the input projection read once and y written once
(bf16), the taps w (bf16) and the bias b (f32, as the benchmark draws them)
read once. Its operations, 2 K + 1 a (t, d) for the taps and the bias at
the f32 peak (the SiLU's left out), lie some 9 times below its bytes: the
bound is in bytes."""
from typing import Dict

from thriftbench.metrics.arith import BF16, F32, PEAK_F32_FLOPS, roofline_bound

COUNTER = "causal_conv1d"
ROW = "causal_conv1d_kernel"


def bound(m: Dict, btype: str, B: int, S: int) -> Dict[str, float]:
    Din, K = m["d_inner"], m["ssm_conv"]
    ops = float(B * S * Din * (2 * K + 1))
    nbytes = float(BF16 * 2 * B * S * Din + BF16 * Din * K + F32 * Din)
    return roofline_bound(ops, nbytes, PEAK_F32_FLOPS)
