"""Ranks of a ``torch.distributed`` gloo world on the CPU for the
expert-parallel MoE tests: a ``(data, model)`` ``DeviceMesh``, each rank
on one torch thread. This module imports no JAX, so spawned ranks start
fast; ``run_world`` runs a function on every rank (this module's
``_rank_work`` unless another is given, on a mesh of ``MESH`` unless
another shape is given) and returns what each rank saved.
"""
from __future__ import annotations

import dataclasses
import multiprocessing
import socket
import sys
from pathlib import Path

import numpy as np
import torch

SRC = str(Path(__file__).resolve().parents[1] / "src")
T, D, F, E, K = 64, 32, 48, 8, 2           # tests/test_perf_features.py's sizes
CAPACITY = 16.0                             # no drops on either path
MESH = (2, 2)                               # (data, model)
GRANITE_TOKENS = (4, 16)                    # B, S of the SMOKE forward


def moe_inputs(seed: int = 0) -> dict:
    """x, router, expert weights (f32) made from ``seed`` with numpy."""
    rng = np.random.default_rng(seed)
    f32 = lambda *shape, s=1.0: rng.normal(0, s, shape).astype(np.float32)
    return {"x": f32(T, D), "rw": f32(D, E), "wg": f32(E, D, F, s=0.2),
            "wu": f32(E, D, F, s=0.2), "wd": f32(E, F, D, s=0.2)}


def granite_tokens(vocab: int, seed: int = 1) -> np.ndarray:
    return np.random.default_rng(seed).integers(0, vocab, GRANITE_TOKENS).astype(np.int64)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, world: int, port: int, out: str, inputs: dict, work=None,
               mesh_shape=MESH) -> None:
    if SRC not in sys.path:
        sys.path.insert(0, SRC)
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=world, rank=rank)
    try:
        mesh = init_device_mesh("cpu", tuple(mesh_shape), mesh_dim_names=("data", "model"))
        torch.save((work or _rank_work)(mesh, inputs), f"{out}/rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def _rank_work(mesh, inputs: dict) -> dict:
    from repro_torch import configs
    from repro_torch.distributed import AxisRules, use_rules
    from repro_torch.models import LM, blocks
    from repro_torch.models.moe import local_experts, moe_mlp_ep

    d = mesh.get_local_rank("data")
    t_l = T // MESH[0]
    w = {k: torch.from_numpy(v) for k, v in inputs.items() if k != "tokens"}
    x_local = w["x"][d * t_l:(d + 1) * t_l].clone().requires_grad_()
    ew = [local_experts(w[n], E, mesh) for n in ("wg", "wu", "wd")]
    y, aux = moe_mlp_ep(x_local, w["rw"], *ew, K, CAPACITY, mesh)
    (y * y).sum().backward()

    cfg = dataclasses.replace(configs.get_smoke_config("granite-moe-1b-a400m"),
                              moe_ep=True, expert_capacity_factor=CAPACITY)
    tokens = torch.from_numpy(inputs["tokens"])
    b_l = tokens.shape[0] // MESH[0]
    model = LM(cfg, device="cpu", seed=0)
    calls = []
    dispatch = blocks.moe_mlp_ep
    blocks.moe_mlp_ep = lambda *a, **kw: calls.append(1) or dispatch(*a, **kw)
    try:
        with use_rules(AxisRules(mesh)), torch.no_grad():
            logits = model(tokens[d * b_l:(d + 1) * b_l])
    finally:
        blocks.moe_mlp_ep = dispatch
    return {"data": d, "model": mesh.get_local_rank("model"), "y": y.detach(),
            "aux": aux.detach(), "grad": x_local.grad, "logits": logits,
            "ep_calls": len(calls)}


def run_world(out: str, inputs: dict, timeout_s: float = 240.0, work=None,
              mesh_shape=MESH) -> list:
    """Run the world's ranks (four on the default (2, 2) mesh), each calling
    ``work(mesh, inputs)`` (a module-level function); each rank's saved
    results, by rank."""
    ctx = multiprocessing.get_context("spawn")
    world, port = mesh_shape[0] * mesh_shape[1], _free_port()
    procs = [ctx.Process(target=_rank_main, args=(r, world, port, out, inputs, work, mesh_shape))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout_s)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise RuntimeError(f"ranks exited with {codes}")
    return [torch.load(f"{out}/rank{r}.pt") for r in range(world)]
