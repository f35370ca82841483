"""AdamW with f32 master weights (the port of ``repro/training/optimizer.py``).

The optimizer state is a dict over the parameters' names (the names of
``LM.named_parameters()``)::

    {"m": {name: f32}, "v": {name: f32}, "master": {name: f32 copy}, "step": int32 scalar}

and every update is done in f32 in the JAX package's order: warmup times
cosine / linear / constant decay, clipping by the global norm, bias
correction, decoupled weight decay, then the master weights cast to each
parameter's dtype. A scalar that divides a tensor is a tensor here: torch
turns ``scalar / t`` (and, on CUDA, ``t / scalar``) into a multiply by a
reciprocal, which JAX does not.

Sharded state: where the parameters are ``DTensor`` tensors
(:mod:`repro_torch.distributed.sharding`), the moments and master weights
have their parameter's placements, every update is computed on the local
blocks (the same numbers, element by element) and the global norm sums
each gradient's squares over its shards (:func:`global_norm`), so clipping
scales every rank alike.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch

from repro_torch.distributed.sharding import like, local_part, shard_sums

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 3e-4
    betas: Tuple[float, float] = (0.9, 0.95)
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    schedule: str = "cosine"       # cosine | linear | constant


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), x, dtype=torch.float32, device=like.device)


def lr_at(cfg: OptimizerConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int or an integer tensor), an f32
    scalar tensor on the step's device."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / _f32(max(cfg.warmup_steps, 1), step), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / _f32(max(cfg.total_steps - cfg.warmup_steps, 1), step), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * (1 + torch.cos(math.pi * t))
    elif cfg.schedule == "linear":
        decay = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * (1.0 - t)
    else:
        decay = _f32(1.0, step)
    return cfg.lr * warm * decay


def adamw_init(params: Tensors) -> Dict:
    """Zero moments, an f32 copy of every parameter (each with its
    parameter's placements where distributed) and step 0."""
    any_p = next(iter(params.values()))
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32, memory_format=torch.contiguous_format)
    return {
        "m": {k: zeros(p) for k, p in params.items()},
        "v": {k: zeros(p) for k, p in params.items()},
        "master": {k: p.detach().to(torch.float32, copy=True) for k, p in params.items()},
        "step": torch.zeros((), dtype=torch.int32, device=any_p.device),
    }


def sum_squares(tree: Tensors) -> list:
    """Each tensor's f32 sum of squares over its whole value (a
    ``DTensor``'s over all its shards)."""
    leaves = list(tree.values())
    return shard_sums([local_part(x).to(torch.float32).square().sum() for x in leaves], leaves)


def global_norm(tree: Tensors) -> torch.Tensor:
    """sqrt of the sum over tensors of each one's f32 sum of squares: a
    plain scalar, the same on every rank."""
    return torch.sqrt(torch.stack(sum_squares(tree)).sum())


def adamw_update(grads: Tensors, opt_state: Dict, params: Tensors,
                 cfg: OptimizerConfig) -> Tuple[Tensors, Dict, Tensors]:
    """One AdamW step. Returns ``(new_params, new_state, {"lr",
    "grad_norm"})``; nothing given is changed in place."""
    step = local_part(opt_state["step"]) + 1
    lr = lr_at(cfg, step)
    b1, b2 = cfg.betas

    gnorm = global_norm(grads)
    scale = torch.where(gnorm > cfg.grad_clip,
                        _f32(cfg.grad_clip, gnorm) / torch.clamp(gnorm, min=1e-12), 1.0)
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(_f32(b1, stepf), stepf)
    bc2 = 1.0 - torch.pow(_f32(b2, stepf), stepf)

    m, v, master, new_params = {}, {}, {}, {}
    for k, g in grads.items():
        g = local_part(g).to(torch.float32) * scale
        mk = b1 * local_part(opt_state["m"][k]) + (1 - b1) * g
        vk = b2 * local_part(opt_state["v"][k]) + (1 - b2) * g * g
        mh = mk / bc1
        vh = vk / bc2
        mp = local_part(opt_state["master"][k])
        mpk = mp - lr * (mh / (torch.sqrt(vh) + cfg.eps) + cfg.weight_decay * mp)
        ref = params[k]
        m[k], v[k], master[k] = like(ref, mk), like(ref, vk), like(ref, mpk)
        new_params[k] = like(ref, mpk.to(ref.dtype))
    new_state = {"m": m, "v": v, "master": master, "step": like(opt_state["step"], step)}
    return new_params, new_state, {"lr": lr, "grad_norm": gnorm}
