"""Gradient compression with error feedback (the port of
``repro/training/compression.py``).

Two codecs, each applied to every gradient after adding its residual:

  * int8: symmetric per-tensor quantize-dequantize (round half to even),
  * top-k: keep the entries of the k largest magnitudes (k a fraction),

with the part the codec dropped kept as the next step's residual (Stich et
al., 2018). On one card there is no data-parallel all-reduce to shrink: the
codec changes the update exactly as it would on a cluster.

The JAX package applies a codec per pytree leaf, and a leaf there is a
segment's stack of one block parameter over its repeats: one int8 scale,
one top-k threshold for all those layers. ``groups`` (from
:meth:`repro_torch.models.LM.stacked_groups`) names the port's tensors
that make up one such leaf, so the port quantizes and sparsifies the same
sets of numbers.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    codec: str = "none"          # none | int8 | topk
    topk_frac: float = 0.01
    error_feedback: bool = True


def init_residuals(params: Tensors) -> Tensors:
    return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device) for k, p in params.items()}


def _int8_codec(gs: List[torch.Tensor]) -> List[torch.Tensor]:
    """Quantize-dequantize to the int8 grid (symmetric, one scale for the
    group). The scale is ``max |g| * f32(1 / 127)``: the reference runs
    under ``jit``, where XLA turns its division by the constant 127 into a
    multiplication by the reciprocal, and one ulp of the scale can move a
    value to the next level."""
    g32 = [g.to(torch.float32) for g in gs]
    amax = torch.stack([g.abs().max() for g in g32]).max()
    scale = torch.clamp(amax, min=1e-12) * float(np.float32(1.0) / np.float32(127.0))
    return [torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8).to(torch.float32) * scale
            for g in g32]


def _topk_codec(gs: List[torch.Tensor], frac: float) -> List[torch.Tensor]:
    """Keep the entries of the group's k largest magnitudes."""
    g32 = [g.to(torch.float32) for g in gs]
    flat = torch.cat([g.reshape(-1) for g in g32])
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat.abs(), k).values[-1]
    return [torch.where(g.abs() >= thresh, g, 0.0) for g in g32]


def compress_grads(
    grads: Tensors, residuals: Optional[Tensors], cfg: CompressionConfig,
    groups: Optional[List[List[str]]] = None,
) -> Tuple[Tensors, Optional[Tensors], Tensors]:
    """Apply the codec with error feedback to each group of tensors (each
    tensor alone where ``groups`` is None). Returns ``(grads,
    new_residuals, stats)``."""
    if cfg.codec == "none":
        return grads, residuals, {}
    if residuals is None:
        residuals = init_residuals(grads)
    groups = [[k] for k in grads] if groups is None else groups
    if sorted(k for names in groups for k in names) != sorted(grads):
        raise ValueError("codec groups must hold every gradient exactly once")
    out, new_res = {}, {}
    for names in groups:
        g32 = [grads[k].to(torch.float32) for k in names]
        if cfg.error_feedback:
            g32 = [g + residuals[k] for g, k in zip(g32, names)]
        if cfg.codec == "int8":
            coded = _int8_codec(g32)
        elif cfg.codec == "topk":
            coded = _topk_codec(g32, cfg.topk_frac)
        else:
            raise ValueError(cfg.codec)
        for k, g, c in zip(names, g32, coded):
            out[k] = c
            new_res[k] = (g - c) if cfg.error_feedback else torch.zeros_like(g)
    out = {k: out[k] for k in grads}
    new_res = {k: new_res[k] for k in grads}
    err = torch.sqrt(sum(x.square().sum() for x in new_res.values()))
    return out, new_res, {"compression_err_norm": err}
