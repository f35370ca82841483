"""The LM (the port of ``repro/models/model.py``): embedding -> blocks ->
logits, and the next-token loss the trainer differentiates.

:class:`LM` is an ``nn.Module`` that owns its weights: a :class:`Block` per
layer, in the JAX package's layer order (``cfg.segments()``, then repeats,
then the pattern unit), each holding its parameters under the JAX names.
The layers run as a Python loop where the JAX package scans stacked
segments; ``cfg.remat`` runs each layer under ``torch.utils.checkpoint``
while grad is enabled (JAX's ``jax.checkpoint``; the numbers do not
change), and the ``constrain`` sharding annotations have no counterpart.
Parameters are frozen for serving; the trainer unfreezes them
(:func:`repro_torch.training.init_train_state`). ``prefill``,
``decode_step`` and ``init_cache`` wait for the decode slice.

Frontend families (vision, audio) take precomputed frontend embeddings
(B, Lf, D), cast to the model dtype and prepended to the token
embeddings; MoE layers add their load-balancing aux loss, which the
backbone sums over the layers and the loss weighs by 0.01 per layer.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from . import blocks as B
from .config import ModelConfig
from .init import init_params, unstack_params
from .mlp import rmsnorm

IGNORE = -1


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
        if btype not in ("attn", "moe", "ssm", "rec"):
            raise ValueError(btype)
        self.btype = btype
        self.cfg = cfg
        self.params = nn.ParameterDict({k: _frozen(v) for k, v in params.items()})

    def forward(self, x: torch.Tensor, window: int):
        """``(output, aux)``: the aux loss of a MoE layer, None for the others."""
        if self.btype == "moe":
            return B.moe_block(self.params, x, self.cfg, window=window)
        if self.btype == "attn":
            return B.attn_block(self.params, x, self.cfg, window=window), None
        if self.btype == "ssm":
            return B.ssm_block(self.params, x, self.cfg), None
        return B.rec_block(self.params, x, self.cfg), None


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

    def stacked_groups(self) -> List[List[str]]:
        """The names of the parameters the JAX package holds as one array:
        each segment stacks one block parameter of its pattern unit over
        its repeats; the embedding, final norm and head stand alone. The
        gradient codecs work per such group, as the JAX package's work per
        leaf."""
        groups = [["tok"], ["final_norm"]] + ([["head"]] if self.head is not None else [])
        base = 0
        for unit, repeats in self.cfg.segments():
            for j in range(len(unit)):
                groups += [[layer_param_name(base + r * len(unit) + j, name)
                            for r in range(repeats)] for name in self.layers[base + j].params]
            base += repeats * len(unit)
        return groups

    def embed(self, tokens: torch.Tensor,
              frontend_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Token embeddings (B, S, D), after the frontend embeddings (B, Lf,
        D) cast to the model dtype where they are given."""
        h = self.tok[tokens]
        if frontend_embeds is not None:
            h = torch.cat([frontend_embeds.to(h.dtype), h], dim=1)
        return h

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """(..., D) -> (..., V) over the padded vocabulary."""
        h = rmsnorm(h, self.final_norm, self.cfg.norm_eps)
        logits = h @ (self.tok.T if self.head is None else self.head)
        if self.cfg.logits_softcap > 0:
            c = self.cfg.logits_softcap
            if torch.is_grad_enabled():
                logits = torch.tanh(logits / c) * c
            else:
                logits = (logits / c).tanh_().mul_(c)    # in place: saves a logits-sized copy
        return logits

    def backbone(self, h: torch.Tensor):
        """Every layer over (B, S, D): ``(h, aux)``, aux the f32 sum of the
        MoE layers' aux losses (0 without MoE layers). Under ``cfg.remat``
        and enabled grad each layer's activations are recomputed in the
        backward."""
        remat = self.cfg.remat and torch.is_grad_enabled()
        aux_total = torch.zeros((), dtype=torch.float32, device=h.device)
        for layer in self.layers:
            h, aux = (checkpoint(layer, h, self.window, use_reentrant=False) if remat
                      else layer(h, self.window))
            if aux is not None:
                aux_total = aux_total + aux
        return h, aux_total

    def forward(self, tokens: torch.Tensor,
                frontend_embeds: Optional[torch.Tensor] = None) -> torch.Tensor:
        """tokens (B, S) [after frontend embeddings (B, Lf, D)] -> logits
        (B, Lf + S, V) in ``cfg.dtype``."""
        h, _ = self.backbone(self.embed(tokens, frontend_embeds))
        return self.logits(h)

    def loss(self, batch: Dict[str, torch.Tensor]):
        """Next-token LM loss: ``(loss, {"nll", "aux"})``. ``batch`` has
        tokens (B, S_tok) and, for frontend archs, frontend_embeds (B, Lf,
        D). ``nll`` is the mean f32 cross-entropy (padded vocab slots
        masked) of each position against the next token: without a frontend
        every position but the last; with one, the last frontend position
        and every token position but the last, against the tokens. MoE
        configs add ``0.01 * aux / num_layers`` to the loss."""
        cfg = self.cfg
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        fe = batch.get("frontend_embeds")
        fe = None if fe is None else torch.as_tensor(fe, device=self.device)
        h = self.embed(tokens, fe)
        Bsz, S = h.shape[0], h.shape[1]
        Lf = 0 if fe is None else fe.shape[1]
        targets = torch.full((Bsz, S), IGNORE, dtype=torch.long, device=self.device)
        if Lf > 0:
            targets[:, Lf - 1: Lf - 1 + tokens.shape[1]] = tokens
        else:
            targets[:, : S - 1] = tokens[:, 1:]
        h, aux = self.backbone(h)
        if cfg.loss_chunk and cfg.loss_chunk < S:
            nloss, ncount = self._chunked_xent(h, targets)
        else:
            nloss, ncount = _xent_sum(self.logits(h), targets, cfg.vocab_size)
        nll = nloss / torch.clamp(ncount, min=1.0)
        loss = nll
        if cfg.num_experts:
            loss = nll + 0.01 * aux / max(len(cfg.layer_types), 1)
        return loss, {"nll": nll, "aux": aux}

    def _chunked_xent(self, h: torch.Tensor, targets: torch.Tensor):
        """``(sum of nll, count)`` over ``cfg.loss_chunk`` positions at a
        time, then the remainder."""
        c, S = self.cfg.loss_chunk, h.shape[1]
        n = S // c
        nloss = ncount = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(n):
            l, k = _xent_sum(self.logits(h[:, i * c:(i + 1) * c]), targets[:, i * c:(i + 1) * c],
                             self.cfg.vocab_size)
            nloss, ncount = nloss + l, ncount + k
        if n * c < S:                                  # remainder
            l, k = _xent_sum(self.logits(h[:, n * c:]), targets[:, n * c:], self.cfg.vocab_size)
            nloss, ncount = nloss + l, ncount + k
        return nloss, ncount


def _xent_sum(logits: torch.Tensor, targets: torch.Tensor, vocab: int):
    """Sum of masked next-token cross-entropies and the valid count (f32):
    padded vocab slots are masked, ``IGNORE`` targets skipped."""
    logits = logits.float()
    V = logits.shape[-1]
    if V > vocab:                                      # mask padded vocab slots
        logits = logits.masked_fill(torch.arange(V, device=logits.device) >= vocab, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    picked = logits.gather(-1, targets.clamp(min=0)[..., None])[..., 0]
    mask = (targets != IGNORE).float()
    return ((lse - picked) * mask).sum(), mask.sum()


def layer_param_name(i: int, name: str) -> str:
    """The ``LM.named_parameters()`` name of layer ``i``'s parameter ``name``
    (a :class:`Block` in ``LM.layers``, its tensors in ``Block.params``)."""
    return f"layers.{i}.params.{name}"


def named_params(layout: Dict) -> Dict[str, torch.Tensor]:
    """The port's per-layer layout (as :class:`LM` takes it) keyed by the
    names of ``LM.named_parameters()``, in their order: ``tok``,
    ``final_norm``, ``head`` (untied), ``layers.<i>.params.<JAX name>``."""
    out = {"tok": layout["embed"]["tok"], "final_norm": layout["final_norm"]}
    if "head" in layout:
        out["head"] = layout["head"]["w"]
    for i, layer in enumerate(layout["layers"]):
        out.update({layer_param_name(i, k): t for k, t in layer.items()})
    return out
