"""Input stand-ins for every (architecture x shape) cell (the port of
``repro/launch/specs.py``).

Every function returns trees of ``torch.empty(..., device="meta")``
tensors, the counterpart of ``jax.ShapeDtypeStruct``: shapes and dtypes,
nothing allocated. The modality frontends of the vision and audio archs
are stubbed as precomputed patch/frame embeddings, as in the JAX package.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.models import LM, ModelConfig, ShapeConfig
from repro_torch.models.model import named_params
from repro_torch.training import adamw_init

META = torch.device("meta")


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def batch_specs_for(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Training / prefill batch: tokens (+ stub frontend embeddings)."""
    lf = cfg.frontend_len if cfg.frontend != "none" else 0
    s_tok = shape.seq_len - lf
    if s_tok <= 0:
        raise ValueError(f"{cfg.name} x {shape.name}: no token positions after the frontend")
    out = {"tokens": _sds((shape.global_batch, s_tok), torch.int32)}
    if lf:
        out["frontend_embeds"] = _sds((shape.global_batch, lf, cfg.d_model),
                                      getattr(torch, cfg.dtype))
    return out


def decode_specs_for(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[Dict, Dict]:
    """(cache, tokens) for one serve step with a seq_len-deep cache of
    ``seq_len - 1`` prefilled positions."""
    model = LM(cfg, device=META)
    cache = model.init_cache(shape.global_batch, shape.seq_len, prefilled=shape.seq_len - 1)
    return cache, {"tokens": _sds((shape.global_batch, 1), torch.int32)}


def param_specs_for(cfg: ModelConfig) -> Dict:
    """The per-layer parameter tree of ``LM(cfg)`` on meta (the layout
    :class:`~repro_torch.models.model.LM` takes)."""
    return model_layout(LM(cfg, device=META))


def model_layout(model: LM) -> Dict:
    """A model's own tensors in the per-layer layout ``{"embed": {"tok"},
    "final_norm", ["head": {"w"}], "layers": [{name: tensor}, ...]}``."""
    out = {"embed": {"tok": model.tok}, "final_norm": model.final_norm,
           "layers": [dict(layer.params) for layer in model.layers]}
    if model.head is not None:
        out["head"] = {"w": model.head}
    return out


def opt_specs_for(param_shapes: Dict) -> Dict:
    """``training.adamw_init`` of a per-layer parameter tree: ``m``, ``v``
    and ``master`` by parameter name, and ``step``."""
    return adamw_init(named_params(param_shapes))


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Everything the step function for this cell consumes (params excluded)."""
    if shape.kind in ("train", "prefill"):
        return {"batch": batch_specs_for(cfg, shape)}
    cache, tokens = decode_specs_for(cfg, shape)
    return {"cache": cache, "batch": tokens}
