"""Model FLOPs the window's answers needed over the window's seconds at the
card's bf16 peak, in %: for each query completed in the window, one forward
through each arm of its plan up to its stop wave
(:func:`thriftbench.metrics.arith.forward_flops`)."""
import numpy as np

from thriftbench.metrics import arith


def read(ctx):
    served, win = ctx["served"], ctx["window"]
    arms = ctx["pool"]["arms"]
    seq = ctx["cell"].mix["seq_len"] - 1
    per_arm = np.asarray([arith.forward_flops(a["model"], seq) for a in arms])
    done = np.zeros(served["pred"].size, bool)
    done[win["completed"]] = True
    flops = 0.0
    for route in served["routes"]:
        for r, q in enumerate(route["qids"]):
            if done[q]:
                order = route["schedule"][r]
                flops += per_arm[order[:max(int(served["stop"][q]), 0)]].sum()
    return 100.0 * flops / (win["window_s"] * arith.PEAK_BF16_FLOPS)
