"""Witnesses for the Moonlight cell's check, run on the card and never by the
benchmark's own runs: ``calibrate.py``'s readings with one change made in
the process first, and the MoE pair counter split by arm.

    python3 thriftbench/witness.py [--plain-ewd] [--fault scaling|bias] -- \\
        --workload moonlight-pool.backlog-full --seeds 11,12 [--control bf16] [calibrate.py's options]
    python3 thriftbench/witness.py --dropped --workload moonlight-pool.backlog-full --seeds 11

``--plain-ewd``: ``blocks/mla_moe.py`` draws the routed experts' ``ewd`` at
fan-in ``expert_d_ff``, the std every other arm's down projection takes,
for the program and the reference alike (the cell draws it at 1 /
``routed_scaling`` of that). ``--control bf16`` (added to the reference's
precisions here): every product the fp8 control rounds, taken instead on
bf16 operands with its result rounded to bf16, as a bf16 GEMM gives it, and
each layer's output rounded to bf16, as the program's residual stream
holds it; the attention products and the norms stay f32. ``--fault``
plants one router fault in the program alone: ``scaling`` weighs the
routed experts at ``routed_scaling`` 1, ``bias`` chooses them without the
selection bias. ``--dropped``: for each seed, the cell's program drawn and
warmed up, then two traced slices of its traffic (``harness.traced_slice``),
the second with every selection bias of the program set to zero; one JSON
line each, the routed and dropped pairs of ``repro_torch.models.moe.PAIRS``
by MoE shape and the arms of that shape.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

import torch  # noqa: E402

from thriftbench import calibrate, harness  # noqa: E402
from thriftbench.blocks import attn, mla, mla_moe, moe, ssm  # noqa: E402
from thriftbench.reference import model as ref_model  # noqa: E402
from thriftbench.spec import Cell  # noqa: E402


def plain_ewd() -> None:
    drawn = mla_moe.spec
    mla_moe.spec = lambda m: [(n, s, kind, m["expert_d_ff"] if n == "ewd" else fan_in)
                              for n, s, kind, fan_in in drawn(m)]


def bf16_control() -> None:
    mm, bmm, block = ref_model.mm, ref_model.bmm, ref_model.block

    def mm16(x, w, precision):
        if precision == "bf16":
            return (x.bfloat16() @ w.bfloat16()).float()
        return mm(x, w, precision)

    def bmm16(x, w, precision):
        if precision == "bf16":
            return torch.bmm(x.bfloat16(), w.bfloat16()).float()
        return bmm(x, w, precision)

    def block16(h, btype, p, m, precision, segments):
        out = block(h, btype, p, m, precision, segments)
        return out.bfloat16().float() if precision == "bf16" else out

    ref_model.PRECISIONS = (*ref_model.PRECISIONS, "bf16")
    ref_model.mm, ref_model.bmm, ref_model.block = mm16, bmm16, block16
    for mod in (attn, mla, mla_moe, moe, ssm):
        for name, fn in (("mm", mm16), ("bmm", bmm16)):
            if hasattr(mod, name):
                setattr(mod, name, fn)


def router_fault(kind: str) -> None:
    from repro_torch.models import moe as program_moe

    route = program_moe.router_sigmoid_topk

    def faulty(logits, k, bias, scaling):
        if kind == "scaling":
            return route(logits, k, bias, 1.0)
        return route(logits, k, torch.zeros_like(bias), scaling)

    program_moe.router_sigmoid_topk = faulty


def dropped(workload: str, seeds) -> None:
    from repro_torch.models import moe as program_moe

    dev = torch.device("cuda:0")
    torch.cuda.set_device(dev)
    cell = Cell(ROOT, workload)
    shapes = {}
    for arm in cell.config["arms"]:
        m = arm["model"]
        if m.get("num_experts"):
            shapes.setdefault(f"{m['num_experts']}x{m['experts_per_token']}", []).append(arm["arch"])
    for seed in seeds:
        prog = harness.build(cell, seed, dev, False, calibrate.log)
        harness.warm_up(prog, cell, seed)
        for zero_bias in (False, True):
            if zero_bias:
                with torch.no_grad():
                    for arm in prog["arms"]:
                        for name, p in arm.model.named_parameters():
                            if name.endswith("router_bias"):
                                p.zero_()
            harness.traced_slice(prog, cell, seed, calibrate.log)
            pairs = program_moe.PAIRS
            by = {f"{e}x{k}": {"arms": shapes.get(f"{e}x{k}"), "routed": pairs.routed((e, k)),
                               "dropped": pairs.dropped((e, k)),
                               "share": pairs.dropped((e, k)) / pairs.routed((e, k))}
                  for e, k in pairs.keys()}
            calibrate.emit({"cell": workload, "seed": seed, "router_bias": "zero" if zero_bias
                            else "drawn", "share": pairs.dropped() / pairs.routed(),
                            "by_shape": by})
        del prog
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--plain-ewd", action="store_true")
    ap.add_argument("--fault", choices=("scaling", "bias"))
    ap.add_argument("--dropped", action="store_true")
    ap.add_argument("--workload")
    ap.add_argument("--seeds")
    args, rest = ap.parse_known_args()
    if args.dropped:
        dropped(args.workload, [int(s) for s in args.seeds.split(",")])
        return 0
    if args.plain_ewd:
        plain_ewd()
    if args.fault:
        router_fault(args.fault)
    bf16_control()
    sys.argv = [sys.argv[0], *[a for a in rest if a != "--"]]
    return calibrate.main()


if __name__ == "__main__":
    sys.exit(main())
