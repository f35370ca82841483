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

Sharded gradients (``DTensor`` tensors) are coded on their local blocks
with the group's global statistics: the int8 scale from the max |g| over
every shard (one all-reduce per mesh dim), the top-k threshold from the
whole group, gathered one group at a time (its f32 gradients whole on
every rank while its threshold is found: at most the largest group, e.g.
the embedding, 4 bytes a parameter).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.distributed.sharding import gather, like, local_part, shard_max

from .optimizer import sum_squares

Tensors = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    codec: str = "none"          # none | int8 | topk
    topk_frac: float = 0.01
    error_feedback: bool = True


def init_residuals(params: Tensors) -> Tensors:
    """Zero f32 residuals, each with its parameter's placements where
    distributed."""
    return {k: torch.zeros_like(p, dtype=torch.float32, memory_format=torch.contiguous_format)
            for k, p in params.items()}


def _int8_codec(gs: List[torch.Tensor], refs=()) -> List[torch.Tensor]:
    """Quantize-dequantize to the int8 grid (symmetric, one scale for the
    group). The scale is ``max |g| * f32(1 / 127)``: the reference runs
    under ``jit``, where XLA turns its division by the constant 127 into a
    multiplication by the reciprocal, and one ulp of the scale can move a
    value to the next level. ``gs`` are local blocks of ``refs`` where
    those are distributed: the max is taken over every shard."""
    g32 = [g.to(torch.float32) for g in gs]
    amax = shard_max(torch.stack([g.abs().max() for g in g32]).max(), refs)
    scale = torch.clamp(amax, min=1e-12) * float(np.float32(1.0) / np.float32(127.0))
    return [torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8).to(torch.float32) * scale
            for g in g32]


def _topk_codec(gs: List[torch.Tensor], frac: float, refs=()) -> List[torch.Tensor]:
    """Keep the entries of the group's k largest magnitudes. ``gs`` are
    local blocks of ``refs`` where those are distributed: k and the
    threshold come from the whole group, gathered."""
    g32 = [g.to(torch.float32) for g in gs]
    whole = gather([like(r, g) for r, g in zip(refs, g32)]) if refs else g32
    flat = torch.cat([g.reshape(-1) for g in whole])
    del whole
    k = max(1, int(flat.shape[0] * frac))
    thresh = torch.topk(flat.abs(), k).values[-1]
    return [torch.where(g.abs() >= thresh, g, 0.0) for g in g32]


def compress_grads(
    grads: Tensors, residuals: Optional[Tensors], cfg: CompressionConfig,
    groups: Optional[List[List[str]]] = None,
) -> Tuple[Tensors, Optional[Tensors], Tensors]:
    """Apply the codec with error feedback to each group of tensors (each
    tensor alone where ``groups`` is None). Returns ``(grads,
    new_residuals, stats)``; a distributed gradient's outputs have its
    placements."""
    if cfg.codec == "none":
        return grads, residuals, {}
    if residuals is None:
        residuals = init_residuals(grads)
    groups = [[k] for k in grads] if groups is None else groups
    if sorted(k for names in groups for k in names) != sorted(grads):
        raise ValueError("codec groups must hold every gradient exactly once")
    out, new_res = {}, {}
    for names in groups:
        refs = [grads[k] for k in names]
        g32 = [local_part(grads[k]).to(torch.float32) for k in names]
        if cfg.error_feedback:
            g32 = [g + local_part(residuals[k]) for g, k in zip(g32, names)]
        if cfg.codec == "int8":
            coded = _int8_codec(g32, refs)
        elif cfg.codec == "topk":
            coded = _topk_codec(g32, cfg.topk_frac, refs)
        else:
            raise ValueError(cfg.codec)
        for k, g, c in zip(names, g32, coded):
            out[k] = like(grads[k], c)
            new_res[k] = like(grads[k], (g - c) if cfg.error_feedback else torch.zeros_like(g))
    out = {k: out[k] for k in grads}
    new_res = {k: new_res[k] for k in grads}
    err = torch.sqrt(sum(sum_squares(new_res)))
    return out, new_res, {"compression_err_norm": err}
