"""The training step (the port of ``repro/training/train_loop.py``):
microbatched f32 gradient accumulation, optional gradient compression,
AdamW.

``train_step(params, opt_state, batch) -> (params, opt_state, metrics)``
keeps the JAX package's signature. The model owns its weights, so the
step writes the new values into the model's parameters in place (one copy
of the weights, not two) and returns them; ``params`` given that are not
the model's own tensors (a restored checkpoint's) are first copied into
the model. The optimizer state is returned anew, never changed in place.

Sharded (the JAX package's step jitted with ``in_shardings`` under
``use_rules(AxisRules(mesh)), mesh``): under rules over a ``DeviceMesh``,
:func:`init_train_state` lays the model's parameters out in place as
``param_specs`` says (``DTensor`` tensors,
:func:`repro_torch.distributed.distribute_parameters`) and the AdamW
state and residuals alike. The step takes the global batch, as
``device_put(batch, batch_specs)`` does, and computes on this rank's
block of each global microbatch (:func:`repro_torch.distributed.batch_block`:
JAX splits the global batch into microbatches first, which decides which
tokens share a MoE capacity); the loss and gradients are the global
batch's (``LM.loss``, :func:`repro_torch.distributed.unshard`). The
outputs pass through ``constrain_params``. Every rank of the mesh calls
the step.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch

from repro_torch.distributed.sharding import (active_rules, batch_block, constrain_params,
                                              distribute_parameters, is_device_mesh, like,
                                              local_part)
from repro_torch.models import LM

from .compression import CompressionConfig, compress_grads, init_residuals
from .optimizer import OptimizerConfig, adamw_init, adamw_update


def _sharded() -> bool:
    rules = active_rules()
    return rules is not None and is_device_mesh(rules.mesh)


def init_train_state(model: LM, comp: CompressionConfig = CompressionConfig()):
    """``(params, opt_state)`` to train ``model``: its parameters (made
    trainable, keyed by name) and a fresh AdamW state, with residuals
    under an error-feedback codec. Under rules over a ``DeviceMesh`` the
    parameters are first distributed in place and the state laid out like
    them. The JAX version's ``key`` has no counterpart: the model was
    initialised when it was built."""
    if _sharded():
        distribute_parameters(model)
    params = {name: p.requires_grad_() for name, p in model.named_parameters()}
    opt = adamw_init(params)
    if comp.codec != "none" and comp.error_feedback:
        opt["residuals"] = init_residuals(params)
    return params, constrain_params(opt)


def _split_microbatches(batch: Dict[str, torch.Tensor], m: int) -> Dict[str, torch.Tensor]:
    """Every leaf (B, ...) as (m, B / m, ...): tokens and, for frontend
    archs, frontend_embeds split alike."""
    def split(x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        if b % m:
            raise ValueError(f"batch {b} not divisible by microbatches {m}")
        return x.reshape(m, b // m, *x.shape[1:])

    return {k: split(v) for k, v in batch.items()}


def make_train_step(
    model: LM,
    opt_cfg: OptimizerConfig,
    comp_cfg: CompressionConfig = CompressionConfig(),
) -> Callable:
    """Build ``train_step(params, opt_state, batch)`` for ``model``;
    ``batch`` holds ``tokens`` (B, S) and, for frontend archs,
    ``frontend_embeds`` (B, Lf, D), B a multiple of
    ``model.cfg.num_microbatches`` (and, sharded, of it times the number
    of batch blocks)."""
    groups = model.stacked_groups()

    def load(params: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        own = dict(model.named_parameters())
        if params.keys() != own.keys():
            raise KeyError(f"params must be the model's {len(own)} named parameters")
        with torch.no_grad():
            for name, p in params.items():
                if p is not own[name]:
                    own[name].copy_(p)
        return own

    def train_step(params, opt_state, batch):
        own = load(params)
        wrt = list(own.values())
        m = model.cfg.num_microbatches
        batch = {k: torch.as_tensor(v, device=model.device) for k, v in batch.items()}
        batch = batch_block(batch, max(m, 1))
        if m <= 1:
            loss, _ = model.loss(batch)
            grads = torch.autograd.grad(loss, wrt)
        else:
            mbatches = _split_microbatches(batch, m)
            gsum = [torch.zeros(local_part(p).shape, dtype=torch.float32, device=p.device)
                    for p in wrt]
            lsum = torch.zeros((), dtype=torch.float32, device=model.device)
            for i in range(m):
                l, _ = model.loss({k: v[i] for k, v in mbatches.items()})
                gsum = [a + local_part(g).to(torch.float32)
                        for a, g in zip(gsum, torch.autograd.grad(l, wrt))]
                lsum = lsum + l.detach()
            div = torch.full((), float(m), dtype=torch.float32, device=model.device)
            grads = [like(p, g / div) for p, g in zip(wrt, gsum)]
            loss = lsum / div
        grads = dict(zip(own, grads))

        residuals = opt_state.get("residuals")
        grads, new_res, comp_stats = compress_grads(grads, residuals, comp_cfg, groups)
        opt_core = {k: v for k, v in opt_state.items() if k != "residuals"}
        new_params, new_opt, opt_stats = adamw_update(grads, opt_core, own, opt_cfg)
        if new_res is not None and comp_cfg.codec != "none":
            new_opt["residuals"] = new_res
        with torch.no_grad():
            for name, p in own.items():
                p.copy_(new_params[name])
        return dict(own), constrain_params(new_opt), {"loss": loss.detach(), **opt_stats,
                                                      **comp_stats}

    return train_step
