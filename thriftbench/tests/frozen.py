"""Readings of the yardstick that must not move when its structure does:
the spec lists, FLOP counts and kernel bounds of every arm the benchmark
and its tiny copy run, and, at tiny sizes on the CPU, digests of the drawn
layouts and of the reference's logits.

    env ATEN_CPU_CAPABILITY=default MKL_ENABLE_INSTRUCTIONS=SSE4_2 MKL_CBWR=COMPATIBLE \
        DNNL_MAX_CPU_ISA=SSE41 python3 thriftbench/tests/frozen.py OUT.json [LABEL ...]

writes them, of every arm or of the arms labelled, from the ``thriftbench``
package first on ``sys.path``, on the CPU paths :data:`PINNED` names
(:func:`pinned` runs it so). The values in
``frozen.json`` beside this file were written so from the harness as it
stood before the block and kernel files (commit 6b62fad), and
``test_thriftbench_frozen.py`` holds the harness to them, arm by arm: an
arm that a later pool file adds is not among them and is not read. Only the
public functions both versions have are called.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

SEQS = (1, 7, 24, 127)
LAUNCHES = ((1, 7), (3, 24), (128, 127))
DRAW_SEEDS = (0, 1, 2**31 + 31)
LOGIT_SEED = 2**31 + 7
LOGIT_ROWS = (2, 3)          # two served batches: a MoE layer's capacity counts each
# A product's and a vectorised function's rounding follow the instruction
# set the libraries pick for the CPU, and the digests with them: these
# paths every x86-64 CPU runs alike, with MKL in its conditional numerical
# reproducibility mode for Intel and compatible CPUs.
PINNED = {"ATEN_CPU_CAPABILITY": "default", "MKL_ENABLE_INSTRUCTIONS": "SSE4_2",
          "MKL_CBWR": "COMPATIBLE", "DNNL_MAX_CPU_ISA": "SSE41"}


def arms():
    """(label, model) of every tiny arm and of every arm of the real pools."""
    import thriftbench
    from thriftbench.tests import tiny

    out = [(name, model) for name, model in sorted(tiny.ARMS.items())]
    for path in sorted((Path(thriftbench.__file__).parent / "configs").glob("*.json")):
        pool = json.loads(path.read_text())
        out += [(f"{pool['name']}/{a['arch']}", a["model"]) for a in pool["arms"]]
    return out


def digest(tensors) -> str:
    h = hashlib.sha256()
    for name, t in tensors:
        t = t.detach().contiguous().cpu()
        h.update(f"{name}:{t.dtype}:{tuple(t.shape)}".encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def shapes(model) -> dict:
    """What shapes alone decide: spec lists, FLOPs, flash and scan bounds."""
    from thriftbench.metrics import arith
    from thriftbench.weights import derived, layer_spec

    m = derived(model)
    out = {"spec": {t: [[n, list(s), k, f] for n, s, k, f in layer_spec(m, t)]
                    for t in sorted(set(m["layer_types"]))},
           "flops": [arith.forward_flops(model, S) for S in SEQS],
           "attention_layers": arith.attention_layers(model),
           "ssm_layers": arith.ssm_layers(model)}
    if arith.attention_layers(model):
        out["flash"] = [arith.flash_launch(model, B, S) for B, S in LAUNCHES]
    if arith.ssm_layers(model):
        out["mamba"] = [arith.mamba_launch(model, B, S) for B, S in LAUNCHES]
    return out


def draws(model) -> list:
    """Digests of the whole layout drawn on the CPU, one a seed."""
    from thriftbench.weights import draw_arm

    out = []
    for seed in DRAW_SEEDS:
        lay = draw_arm(model, seed, 2, "cpu")
        tensors = [("tok", lay["embed"]["tok"]), ("final_norm", lay["final_norm"])]
        if "head" in lay:
            tensors.append(("head", lay["head"]["w"]))
        for i, layer in enumerate(lay["layers"]):
            tensors += [(f"{i}.{k}", v) for k, v in layer.items()]
        out.append(digest(tensors))
    return out


def logits(model) -> dict:
    """Digests of the reference's answer logits, f32 and the fp8 control, on
    one thread (a product's rounding follows its split over threads)."""
    from thriftbench.reference.model import answer_logits

    before = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        tokens = torch.as_tensor(np.random.default_rng(3).integers(0, 512, (sum(LOGIT_ROWS), 23)))
        return {p: digest([("logits", answer_logits(model, tokens, LOGIT_SEED, 1, p,
                                                    segments=list(LOGIT_ROWS)))])
                for p in ("f32", "fp8")}
    finally:
        torch.set_num_threads(before)


def readings(labels=None) -> dict:
    """The readings of every arm, or of the arms ``labels`` names."""
    from thriftbench.tests import tiny

    out = {}
    for label, model in arms():
        if labels is not None and label not in labels:
            continue
        out[label] = {"shapes": shapes(model)}
        if label in tiny.ARMS:
            out[label]["draws"] = draws(model)
            out[label]["logits"] = logits(model)
    return out


def pinned(out: Path, labels) -> dict:
    """:func:`readings` of the arms ``labels`` names, from the
    ``thriftbench`` package this file belongs to, in a fresh process on the
    :data:`PINNED` paths."""
    root = str(Path(__file__).resolve().parents[2])
    path = os.pathsep.join([root] + [p for p in [os.environ.get("PYTHONPATH")] if p])
    subprocess.run([sys.executable, __file__, str(out), *labels], check=True, timeout=600,
                   env=dict(os.environ, PYTHONPATH=path, **PINNED))
    return json.loads(Path(out).read_text())


if __name__ == "__main__":
    Path(sys.argv[1]).write_text(json.dumps(readings(sys.argv[2:] or None), indent=1,
                                            sort_keys=True) + "\n")
