"""Training launcher of the port (``repro/launch/train.py``): real steps on
``--device`` (default ``cuda``; a missing card is an error, never a
fallback to the CPU), with checkpoint/restart.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m --smoke \\
        --steps 50 --batch 8 --seq 64 --device cpu

``--smoke`` trains the reduced same-family config; frontend archs
(internvl2-2b, musicgen-medium) train on ``--seq`` positions of which
the first ``frontend_len`` are frontend embeddings. Training state takes
about 14 bytes a parameter (bf16 weights and gradients, f32 master
weights and moments). By that count smollm-135m (135 M parameters)
trains at full width on one 80 GB card, and granite-moe-1b-a400m,
h2o-danube-1.8b, internvl2-2b and musicgen-medium (1.3-1.9 B, 19-27 GB
of state) are within one; the 7-111 B configs are not, and train at
``--smoke`` only. Each run resumes from the newest
checkpoint under ``--ckpt/<config name>`` (default under the
repository's ``build/``) and saves every ``--save-every`` steps; a resumed
run prints ``resumed from step <n>``.

``--mesh DATAxMODEL`` trains sharded: every rank of a ``torch.distributed``
world (started by ``torchrun``, which sets ``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR`` and ``MASTER_PORT``; NCCL with one card a rank, gloo with
``--device cpu``) runs this launcher, the state laid out over a
``("data", "model")`` ``DeviceMesh`` as ``param_specs`` says and each step
on the same global batch, split over the data axis::

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --arch smollm-135m \
        --smoke --steps 20 --device cpu --mesh 2x2

Rank 0 prints and writes the checkpoints (every rank gathers for a save).
Every rank builds the whole model before it is distributed.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import time
from pathlib import Path

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.data import DataPipeline
from repro_torch.distributed.fault import FaultTolerantDriver
from repro_torch.models import LM
from repro_torch.training import (CompressionConfig, OptimizerConfig, init_train_state,
                                  make_train_step)

DEFAULT_CKPT = Path(__file__).resolve().parents[3] / "build" / "train_ckpt"


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=list_archs())
    ap.add_argument("--smoke", action="store_true", help="use the reduced config")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt", default=str(DEFAULT_CKPT))
    ap.add_argument("--save-every", type=int, default=25)
    ap.add_argument("--compress", default="none", choices=["none", "int8", "topk"])
    ap.add_argument("--device", default="cuda",
                    help="where to train (cuda needs a card; cpu runs the plain versions)")
    ap.add_argument("--mesh", default=None, metavar="DATAxMODEL",
                    help="train sharded over a (data, model) mesh of the torchrun world")
    args = ap.parse_args(argv)

    device, rules, rank, joined = args.device, contextlib.nullcontext(), 0, False
    if args.mesh:
        device, rules, rank, joined = _join_world(args.mesh, args.device)
    say = print if rank == 0 else (lambda *a, **k: None)
    try:
        cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
        model = LM(cfg, device=device, seed=0)
        comp = CompressionConfig(codec=args.compress)
        with rules:
            _train(args, cfg, model, comp, rank, say)
    finally:
        if joined:
            import torch.distributed as dist

            dist.destroy_process_group()


def _join_world(mesh: str, device: str):
    """``(this rank's device, the sharding rules' context, rank, whether
    the process group was started here)`` for ``--mesh``: the process
    group (from torchrun's environment, unless one is up) and a
    ``("data", "model")`` mesh over it."""
    import torch
    import torch.distributed as dist

    from repro_torch.distributed import AxisRules, use_rules
    from repro_torch.launch.mesh import make_mesh

    shape = tuple(int(n) for n in mesh.lower().split("x"))
    kind = torch.device(device).type
    if kind == "cuda":
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    joined = not dist.is_initialized()
    if joined:
        dist.init_process_group("nccl" if kind == "cuda" else "gloo", init_method="env://",
                                **({"device_id": dev} if kind == "cuda" else {}))
    rules = use_rules(AxisRules(make_mesh(shape, ("data", "model"), kind)))
    return dev, rules, dist.get_rank(), joined


def _train(args, cfg, model, comp, rank: int, say) -> None:
    params, opt = init_train_state(model, comp)
    n = sum(p.numel() for p in params.values())
    say(f"[{cfg.name}] {n/1e6:.2f}M params, {args.steps} steps")

    step_fn = make_train_step(
        model, OptimizerConfig(lr=args.lr, warmup_steps=10, total_steps=args.steps), comp,
    )

    rng = np.random.default_rng(0)
    lf = cfg.frontend_len if cfg.frontend != "none" else 0

    def make_batch(step):
        """``seq - lf`` tokens, then for frontend archs ``lf`` N(0, 1)
        frontend embeddings: the JAX launcher's draws, in its order."""
        b = {"tokens": rng.integers(0, cfg.vocab_size, (args.batch, args.seq - lf)).astype(np.int32)}
        if lf:
            b["frontend_embeds"] = rng.normal(0, 1, (args.batch, lf, cfg.d_model)).astype(np.float32)
        return b

    pipe = DataPipeline(make_batch)
    mgr = CheckpointManager(os.path.join(args.ckpt, cfg.name), host_id=rank)
    driver = FaultTolerantDriver(mgr, save_every=args.save_every)
    state, start = driver.restore({"params": params, "opt": opt})
    params, opt = state["params"], state["opt"]
    if start:
        say(f"resumed from step {start - 1}")

    t0 = time.time()
    try:
        for s in range(start, args.steps):
            params, opt, m = step_fn(params, opt, next(pipe))
            driver.maybe_save(s, {"params": params, "opt": opt})
            if s % 10 == 0 or s == args.steps - 1:
                say(f"step {s:4d} loss {float(m['loss']):.4f} lr {float(m['lr']):.2e}")
    finally:
        pipe.close()
    say(f"done in {time.time()-t0:.1f}s")


if __name__ == "__main__":
    main()
