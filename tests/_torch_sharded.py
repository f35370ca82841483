"""Rank functions for the sharded train step and the elastic re-mesh
restart tests, run by ``_torch_ep.run_world`` on spawned gloo ranks (one
torch thread each). This module imports no JAX.

* :func:`train_world`: each case of ``inputs["cases"]`` on a ``(data,
  model)`` mesh: the model distributed by ``init_train_state`` under
  ``AxisRules(mesh)``, its loss at the initial weights, its steps on the
  global batches, every rank's local state shapes, the whole state after
  the steps (``gather``); then the kernel wrappers handed a ``DTensor``.
* :func:`elastic_world`: ``inputs["phase"] == "train"`` takes steps and
  saves a checkpoint; ``"resume"`` restores it through
  ``FaultTolerantDriver`` on this world's (shrunk) mesh and takes steps.
* :func:`cli_world`: the training launcher with ``--mesh`` on every rank,
  its printed lines.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


def _cfg(arch: str, changes: dict):
    from repro_torch import configs

    return dataclasses.replace(configs.get_smoke_config(arch), **changes)


def _batch(b: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _shapes(tree: dict) -> dict:
    from repro_torch.distributed.sharding import local_part

    return {k: tuple(local_part(v).shape) for k, v in tree.items()}


def _coords(mesh) -> tuple:
    return mesh.get_local_rank("data"), mesh.get_local_rank("model")


def _train_case(mesh, case: dict) -> dict:
    from repro_torch.distributed import AxisRules, use_rules
    from repro_torch.distributed.sharding import batch_block, gather
    from repro_torch.models import LM
    from repro_torch.training import (CompressionConfig, OptimizerConfig, init_train_state,
                                      make_train_step)

    cfg = _cfg(case["arch"], case["changes"])
    comp = CompressionConfig(codec=case["codec"])
    model = LM(cfg, device="cpu", params=case.get("params"), seed=0)
    with use_rules(AxisRules(mesh)):
        params, opt = init_train_state(model, comp)
        shapes = {"params": _shapes(params), "step": tuple(opt["step"].to_local().shape)}
        shapes.update({k: _shapes(opt[k]) for k in ("m", "v", "master", "residuals") if k in opt})
        with torch.no_grad():
            loss, met = model.loss(batch_block(_batch(case["batches"][0])))
        first = {"loss": float(loss), "nll": float(met["nll"]), "aux": float(met["aux"])}
        step = make_train_step(model, OptimizerConfig(**case["opt"]), comp)
        metrics = []
        for b in case["batches"]:
            params, opt, m = step(params, opt, _batch(b))
            metrics.append({k: float(v) for k, v in m.items()})
        whole = gather({"params": params, "opt": opt})
    out = {"shapes": shapes, "first": first, "metrics": metrics}
    if _coords(mesh) == (0, 0):
        out["state"] = whole
    return out


def _kernel_guard(mesh) -> dict:
    """What each kernel wrapper (and ``KernelFunction``) does with a
    ``DTensor``: the ``TypeError`` it raised, or None where it did not."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.kernels import ops

    rep = [Replicate(), Replicate()]
    d = lambda *shape: distribute_tensor(torch.rand(*shape), mesh, rep)
    q, a, x = d(1, 4, 2, 8), d(1, 4, 8), d(1, 4, 8)
    resp = distribute_tensor(torch.zeros((2, 3), dtype=torch.int32), mesh, rep)
    calls = {
        "flash_attention": lambda: ops.flash_attention(q, q, q),
        "rglru_scan": lambda: ops.rglru_scan(a, a, d(1, 8)),
        "mamba_scan": lambda: ops.mamba_scan(x, x, d(8, 2), d(1, 4, 2), d(1, 4, 2), d(8)),
        "causal_conv1d": lambda: ops.causal_conv1d(x, d(8, 4), d(8)),
        "belief_aggregate": lambda: ops.belief_aggregate(resp, d(3), d(2), 4),
        "KernelFunction": lambda: ops.KernelFunction.apply(lambda t: t, lambda t: t, {}, q),
    }
    out = {}
    for name, call in calls.items():
        try:
            call()
            out[name] = None
        except TypeError as e:
            out[name] = str(e)
    return out


def train_world(mesh, inputs: dict) -> dict:
    torch.manual_seed(0)
    return {"coords": _coords(mesh),
            "cases": {c["name"]: _train_case(mesh, c) for c in inputs["cases"]},
            "guard": _kernel_guard(mesh)}


def elastic_world(mesh, inputs: dict) -> dict:
    import torch.distributed as dist

    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.distributed import AxisRules, FaultTolerantDriver, use_rules
    from repro_torch.models import LM
    from repro_torch.training import OptimizerConfig, init_train_state, make_train_step

    cfg = _cfg(inputs["arch"], inputs["changes"])
    mgr = CheckpointManager(inputs["ckpt_dir"], host_id=dist.get_rank())
    model = LM(cfg, device="cpu", seed=0)
    out = {"coords": _coords(mesh)}
    with use_rules(AxisRules(mesh)):
        params, opt = init_train_state(model)
        if inputs["phase"] == "resume":
            state, start = FaultTolerantDriver(mgr).restore({"params": params, "opt": opt})
            params, opt = state["params"], state["opt"]
            out["restored_step"] = start - 1
            out["restored_shapes"] = _shapes(params)
        step = make_train_step(model, OptimizerConfig(**inputs["opt"]))
        losses = []
        for b in inputs["batches"]:
            params, opt, m = step(params, opt, _batch(b))
            losses.append(float(m["loss"]))
        if inputs["phase"] == "train":
            mgr.save(inputs["save_step"], {"params": params, "opt": opt})
    out["losses"] = losses
    return out


def cli_world(mesh, inputs: dict) -> dict:
    import contextlib
    import io

    from repro_torch.launch import train

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        train.main(inputs["argv"])
    return {"coords": _coords(mesh), "lines": out.getvalue().strip().splitlines()}
