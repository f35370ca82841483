"""Dry run of every (architecture x shape x mesh) cell (the port of
``repro/launch/dryrun.py``).

Each cell builds its model, optimizer state, batch and cache on the
``meta`` device at full published width (shapes and dtypes only, nothing
allocated), works out their specs on the cell's production mesh layout,
and runs the cell's step on meta under ``FlopCounterMode``: the train step
(``LM.loss``, backward, AdamW), ``LM.prefill`` or ``LM.decode_step``, as
the JAX cell lowers it. That is the counterpart of lowering plus
``cost_analysis``: it proves the shapes go through at full width and
counts the step's matmul FLOPs. The record holds the JAX package's
analytic fields with the H100's constants (``launch/mesh.py`` ``HW``),
the per-device argument bytes under the specs, and the counted FLOPs.

No counterpart: the compiled HLO's collective bytes (the port has no
compiler output that names collectives; the record says so, and the
roofline's collective term is not counted), XLA's memory analysis (its
argument size is ``argument_bytes_per_device`` here) and compile time.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --out build/dryrun

Runs on any machine, no card needed; the JSON records go to ``--out``
(default ``build/dryrun``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback
from typing import Any, Dict, List, Optional

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.distributed.sharding import (
    AxisRules,
    batch_specs,
    cache_specs,
    param_specs,
    use_rules,
)
from repro_torch.launch.mesh import HW, make_production_mesh
from repro_torch.launch.roofline import (
    analytic_bytes,
    analytic_flops,
    analytic_memory,
    flop_count,
    model_flops,
    roofline_terms,
)
from repro_torch.launch.specs import META, batch_specs_for, decode_specs_for, model_layout
from repro_torch.models import LM, SHAPES, shape_applicable
from repro_torch.training import OptimizerConfig, init_train_state, make_train_step

DEFAULT_OUT = os.path.join("build", "dryrun")
NO_COLLECTIVES = "not counted: the port has no HLO"


def argument_bytes(tree: Any, specs: Any) -> int:
    """Per-device bytes of the tensors of ``tree`` under ``specs`` (a
    matching tree of :class:`~repro_torch.distributed.sharding.Sharding`):
    each leaf's shard shape times its element size. Host values (a
    cache's ``pos``) hold no device memory."""
    if isinstance(tree, dict):
        return sum(argument_bytes(v, specs[k]) for k, v in tree.items())
    if isinstance(tree, (list, tuple)):
        return sum(argument_bytes(v, s) for v, s in zip(tree, specs))
    if not isinstance(tree, torch.Tensor):
        return 0
    return math.prod(specs.shard_shape(tree.shape)) * tree.element_size()


def _mesh_name(multi_pod: bool) -> str:
    return "2x16x16" if multi_pod else "16x16"


def dryrun_cell(
    arch: str,
    shape_name: str,
    multi_pod: bool = False,
    rules_overrides: Optional[Dict[str, Any]] = None,
    cfg_overrides: Optional[Dict[str, Any]] = None,
    verbose: bool = True,
) -> Dict[str, Any]:
    """Trace one cell on meta; returns the roofline record.

    ``rules_overrides`` remaps logical sharding axes and ``cfg_overrides``
    patches ModelConfig fields, as in the JAX package.
    """
    cfg = get_config(arch)
    if cfg_overrides:
        cfg = dataclasses.replace(cfg, **cfg_overrides)
    cfg.refuse_mla("the sharded dry run and its sharding specs")
    shape = SHAPES[shape_name]
    mesh_name = _mesh_name(multi_pod)
    rec: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "kind": shape.kind,
    }
    if not shape_applicable(cfg, shape):
        rec["skipped"] = "full-attention arch: long_500k requires sub-quadratic attention"
        return rec

    mesh = make_production_mesh(multi_pod=multi_pod)
    chips = mesh.size
    rules = AxisRules(mesh, rules_overrides or {})

    t0 = time.time()
    model = LM(cfg, device=META)
    params = model_layout(model)
    arg_bytes = argument_bytes(params, param_specs(params, rules))
    with use_rules(rules):
        if shape.kind == "train":
            named, opt = init_train_state(model)
            batch = batch_specs_for(cfg, shape)
            arg_bytes += argument_bytes(opt, param_specs(opt, rules))
            arg_bytes += argument_bytes(batch, batch_specs(batch, rules))
            step = make_train_step(model, OptimizerConfig())
            counted = flop_count(step, named, opt, batch)
        elif shape.kind == "prefill":
            batch = batch_specs_for(cfg, shape)
            arg_bytes += argument_bytes(batch, batch_specs(batch, rules))
            counted = flop_count(model.prefill, batch["tokens"], batch.get("frontend_embeds"))
        else:  # decode
            cache, tokens = decode_specs_for(cfg, shape)
            arg_bytes += argument_bytes(cache, cache_specs(cache, rules))
            arg_bytes += argument_bytes(tokens, batch_specs(tokens, rules))
            counted = flop_count(model.decode_step, cache, tokens["tokens"])
    t_trace = time.time() - t0

    fl = analytic_flops(cfg, shape)
    by = analytic_bytes(cfg, shape)
    mf = model_flops(cfg, shape)
    terms = roofline_terms(fl["total"], by["total"], 0.0, chips, HW)
    tp = mesh.shape["model"]
    amem = analytic_memory(cfg, shape, dp=chips // tp, tp=tp)

    rec.update(
        {
            "chips": chips,
            "trace_s": round(t_trace, 2),
            "analytic_memory": amem,
            "fits_hbm": amem["total"] <= HW["hbm_bytes"],
            "argument_bytes_per_device": float(arg_bytes),
            "counted_flops": counted,
            "analytic_flops_total": fl["total"],
            "analytic_flops_fwd": fl["fwd"],
            "analytic_bytes": by["total"],
            "model_flops": mf,
            "useful_flops_ratio": mf / fl["total"] if fl["total"] else 0.0,
            "collective_bytes": None,
            "collective_note": NO_COLLECTIVES,
            "roofline": terms,
        }
    )
    if verbose:
        print(
            f"[{arch} x {shape_name} x {mesh_name}] trace={t_trace:.1f}s "
            f"mem/device={amem['total']/1e9:.2f}GB "
            f"fits={rec['fits_hbm']} "
            f"compute={terms['compute_s']*1e3:.2f}ms mem={terms['memory_s']*1e3:.2f}ms "
            f"coll=not counted -> {terms['bottleneck']} "
            f"counted/analytic flops={counted / fl['total']:.3f}"
        )
    return rec


def main(argv: Optional[List[str]] = None) -> List[Dict[str, Any]]:
    """The CLI; returns the records it wrote."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--all", action="store_true", help="run every (arch x shape) cell")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    archs = list_archs() if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = [False, True] if (args.all or args.both_meshes) else [args.multi_pod]
    records = []
    for a in archs:
        for s in shapes:
            for mp in meshes:
                tag = f"{a}__{s}__{_mesh_name(mp)}"
                path = os.path.join(args.out, tag + ".json")
                if args.skip_existing and os.path.exists(path):
                    print(f"skip {tag} (exists)")
                    continue
                try:
                    rec = dryrun_cell(a, s, multi_pod=mp)
                except Exception as e:  # a failure here is a bug in the system
                    rec = {
                        "arch": a, "shape": s, "mesh": _mesh_name(mp),
                        "error": f"{type(e).__name__}: {e}",
                        "traceback": traceback.format_exc()[-4000:],
                    }
                    print(f"FAIL {tag}: {rec['error']}")
                with open(path, "w") as f:
                    json.dump(rec, f, indent=1, default=float)
                records.append(rec)
    return records


if __name__ == "__main__":
    main()
