"""The LM (the port of ``repro/models/model.py``, forward only): embedding
-> blocks -> logits.

:class:`LM` is an ``nn.Module`` that owns its weights: a :class:`Block` per
layer, in the JAX package's layer order (``cfg.segments()``, then repeats,
then the pattern unit), each holding its parameters under the JAX names.
The layers run as a Python loop; the JAX package's scan over stacked
segments, ``jax.checkpoint`` (remat) and the ``constrain`` sharding
annotations have no counterpart. ``prefill``, ``decode_step``,
``init_cache``, ``loss`` and ``_chunked_xent`` wait for the decode and
training slices.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from . import blocks as B
from .config import ModelConfig
from .init import init_params, unstack_params
from .mlp import rmsnorm


def block_window(cfg: ModelConfig) -> int:
    """Window of the attention blocks: hybrid archs use the local window."""
    if "rec" in cfg.block_pattern:
        return cfg.local_window
    return cfg.window


def _frozen(t: torch.Tensor) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One layer: its block type and its parameters under the JAX names."""

    def __init__(self, btype: str, cfg: ModelConfig, params: Dict[str, torch.Tensor]):
        super().__init__()
        if btype not in ("attn", "ssm", "rec"):
            raise ValueError(f"block type {btype!r} is not ported yet")
        self.btype = btype
        self.cfg = cfg
        self.params = nn.ParameterDict({k: _frozen(v) for k, v in params.items()})

    def forward(self, x: torch.Tensor, window: int) -> torch.Tensor:
        if self.btype == "attn":
            return B.attn_block(self.params, x, self.cfg, window=window)
        if self.btype == "ssm":
            return B.ssm_block(self.params, x, self.cfg)
        return B.rec_block(self.params, x, self.cfg)


class LM(nn.Module):
    """A language model of ``cfg`` on ``device``.

    ``params`` is the port's per-layer layout
    (:func:`repro_torch.models.init.unstack_params`); without it the model
    is initialised from a ``torch.Generator`` on ``device`` seeded with
    ``seed``, straight into ``cfg.dtype``.
    """

    def __init__(self, cfg: ModelConfig, device="cuda", params: Optional[Dict] = None,
                 seed: int = 0):
        super().__init__()
        self.cfg = cfg
        dev = torch.device(device)
        if params is None:
            gen = torch.Generator(device=dev)
            gen.manual_seed(seed)
            params = unstack_params(init_params(gen, cfg), cfg)
        put = lambda t: _frozen(torch.as_tensor(t).to(dev))
        self.tok = put(params["embed"]["tok"])
        self.final_norm = put(params["final_norm"])
        self.head = put(params["head"]["w"]) if not cfg.tie_embeddings else None
        if len(params["layers"]) != cfg.num_layers:
            raise ValueError(f"{len(params['layers'])} layers given, cfg has {cfg.num_layers}")
        self.layers = nn.ModuleList(
            Block(t, cfg, {k: torch.as_tensor(v).to(dev) for k, v in p.items()})
            for t, p in zip(cfg.layer_types, params["layers"])
        )
        self.window = block_window(cfg)

    @property
    def device(self) -> torch.device:
        return self.tok.device

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        return self.tok[tokens]

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """(..., D) -> (..., V) over the padded vocabulary."""
        h = rmsnorm(h, self.final_norm, self.cfg.norm_eps)
        logits = h @ (self.tok.T if self.head is None else self.head)
        if self.cfg.logits_softcap > 0:
            c = self.cfg.logits_softcap
            logits = (logits / c).tanh_().mul_(c)    # in place: saves a logits-sized copy
        return logits

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        """tokens (B, S) -> logits (B, S, V) in ``cfg.dtype``."""
        h = self.embed(tokens)
        for layer in self.layers:
            h = layer(h, self.window)
        return self.logits(h)
