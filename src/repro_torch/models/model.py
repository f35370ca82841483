"""The LM (the port of ``repro/models/model.py``): embedding -> blocks ->
logits, and the next-token loss the trainer differentiates.

:class:`LM` is an ``nn.Module`` that owns its weights: a :class:`Block` per
layer, in the JAX package's layer order (``cfg.segments()``, then repeats,
then the pattern unit), each holding its parameters under the JAX names.
The layers run as a Python loop where the JAX package scans stacked
segments; ``cfg.remat`` runs each layer under ``torch.utils.checkpoint``
while grad is enabled (JAX's ``jax.checkpoint``; the numbers do not
change). Parameters are frozen for serving; the trainer unfreezes them
(:func:`repro_torch.training.init_train_state`).

Sharded (under rules over a ``DeviceMesh``, the parameters ``DTensor`` tensors
laid out by ``param_specs``:
:func:`repro_torch.distributed.distribute_parameters`): each layer gathers
its parameters whole at their use (:func:`~repro_torch.distributed.unshard`,
ZeRO-3), inside its ``checkpoint`` region, so that under remat the backward
gathers them again instead of keeping every layer whole; the embedding,
final norm and head are gathered once per call. The tokens are this rank's
block of the batch, and the loss sums its nll and count over the global
batch (:func:`~repro_torch.distributed.batch_sum`). Activations are not
sharded: the ``constrain`` annotations stay the identity.

Serving one token at a time: :meth:`LM.prefill` runs the full-sequence
blocks (through the model kernels on the card) and keeps each layer's
cache, :meth:`LM.decode_step` runs the one-token blocks (plain torch, as
the JAX package's decode has no Pallas kernel) and :meth:`LM.init_cache`
makes an empty cache. A cache is ``{"pos": int, "ring": (T,) int32 or
None, "layers": [per-layer dict]}``: ``pos`` the next token's absolute
position, kept on the host so a slot costs no device sync; ``ring`` the
absolute position in each attention slot (-1 empty), on the model's
device; ``layers`` indexed like ``LM.layers`` (the JAX package stacks
them per segment, time on dim 2; here time is dim 1 of each leaf;
:func:`repro_torch.convert.cache_from_jax` converts). Windowed caches are
rings of ``T = min(window, S)`` slots, as in the JAX package; a prefill
shorter than the window therefore decodes over slot 0's key while it is
still inside the window, a behaviour both packages share (ROADMAP F4).
Full-attention caches get ``extra_slots`` free slots, past which the
last slot is overwritten.

Frontend families (vision, audio) take precomputed frontend embeddings
(B, Lf, D), cast to the model dtype and prepended to the token
embeddings; MoE layers add their load-balancing aux loss, which the
backbone sums over the layers and the loss weighs by 0.01 per layer.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.distributed.sharding import batch_sum, unshard

from . import blocks as B
from .config import MLA_TYPES, ModelConfig
from .init import init_params, unstack_params
from .mlp import rmsnorm

IGNORE = -1
ATTENTION_TYPES = ("attn", "moe", "mla", "mla_moe")   # the block types with a k/v or latent cache


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
        if btype not in ("attn", "moe", "ssm", "rec", "mla", "mla_moe"):
            raise ValueError(btype)
        self.btype = btype
        self.cfg = cfg
        self.params = nn.ParameterDict({k: _frozen(v) for k, v in params.items()})

    def whole_params(self) -> Dict[str, torch.Tensor]:
        """The parameters by JAX name, whole: gathered where distributed."""
        return {k: unshard(v) for k, v in self.params.items()}

    def forward(self, x: torch.Tensor, window: int):
        """``(output, aux)``: the aux loss of a MoE layer, None for the others
        (and for a sigmoid-routed one)."""
        params = self.whole_params()
        if self.btype == "moe":
            return B.moe_block(params, x, self.cfg, window=window)
        if self.btype == "mla_moe":
            return B.mla_moe_block(params, x, self.cfg, window=window)
        if self.btype == "attn":
            return B.attn_block(params, x, self.cfg, window=window), None
        if self.btype == "mla":
            return B.mla_block(params, x, self.cfg, window=window), None
        if self.btype == "ssm":
            return B.ssm_block(params, x, self.cfg), None
        return B.rec_block(params, x, self.cfg), None

    def prefill(self, x: torch.Tensor, window: int):
        """``(output, cache)`` over the whole sequence."""
        params = self.whole_params()
        if self.btype in ("moe", "mla_moe"):
            fn = B.moe_block if self.btype == "moe" else B.mla_moe_block
            x, _, cache = fn(params, x, self.cfg, window=window, make_cache=True)
            return x, cache
        if self.btype in ("attn", "mla"):
            fn = B.attn_block if self.btype == "attn" else B.mla_block
            return fn(params, x, self.cfg, window=window, make_cache=True)
        if self.btype == "ssm":
            return B.ssm_block(params, x, self.cfg, make_cache=True)
        return B.rec_block(params, x, self.cfg, make_cache=True)

    def decode(self, x: torch.Tensor, cache: B.Cache, pos: int, window: int,
               ring: Optional[torch.Tensor]) -> torch.Tensor:
        """One token (B, 1, D); ``cache`` is written in place."""
        params = self.whole_params()
        if self.btype in ATTENTION_TYPES:
            fn = {"attn": B.attn_block_decode, "moe": B.moe_block_decode,
                  "mla": B.mla_block_decode, "mla_moe": B.mla_moe_block_decode}[self.btype]
            return fn(params, x, cache, self.cfg, pos, window=window, ring_pos=ring)[0]
        fn = B.ssm_block_decode if self.btype == "ssm" else B.rec_block_decode
        return fn(params, x, cache, self.cfg, pos)[0]


class LM(nn.Module):
    """A language model of ``cfg`` on ``device``.

    ``params`` is the port's per-layer layout
    (:func:`repro_torch.models.init.unstack_params`); without it the model
    is initialised from a ``torch.Generator`` on ``device`` seeded with
    ``seed``, straight into ``cfg.dtype``. On ``device="meta"`` the model
    has every shape and dtype and holds no memory: the launch tools'
    specs and dry run (:mod:`repro_torch.launch.specs`) run it there.
    """

    def __init__(self, cfg: ModelConfig, device="cuda", params: Optional[Dict] = None,
                 seed: int = 0):
        super().__init__()
        self.cfg = cfg
        dev = torch.device(device)
        if params is None:
            gen = None                          # meta: shapes only, nothing to draw
            if dev.type != "meta":
                gen = torch.Generator(device=dev)
                gen.manual_seed(seed)
            params = unstack_params(init_params(gen, cfg, dev), cfg)
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
        return _embed(unshard(self.tok), tokens, frontend_embeds)

    def logits(self, h: torch.Tensor) -> torch.Tensor:
        """(..., D) -> (..., V) over the padded vocabulary."""
        return self._logits(h, *self._whole_head(unshard(self.tok) if self.head is None else None))

    def _whole_head(self, tok: torch.Tensor):
        """``(final_norm, output matrix (D, V))`` whole: the untied head, or
        the transpose of ``tok``, the embedding already gathered (unused
        where the head is untied)."""
        out = tok.T if self.head is None else unshard(self.head)
        return unshard(self.final_norm), out

    def _logits(self, h: torch.Tensor, norm: torch.Tensor, out: torch.Tensor) -> torch.Tensor:
        """:meth:`logits` on the whole final norm and output matrix."""
        h = rmsnorm(h, norm, self.cfg.norm_eps)
        logits = h @ out
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
        tok = unshard(self.tok)                          # gathered once for both ends
        h, _ = self.backbone(_embed(tok, tokens, frontend_embeds))
        return self._logits(h, *self._whole_head(tok))

    # ------------------------------------------------------------- serving
    def attn_cache_len(self, seq_len: int) -> int:
        """Slots of the attention caches after a prefill of ``seq_len``
        positions (0 without attention layers): ``min(window, seq_len)``
        when windowed, else ``seq_len``."""
        if not set(self.cfg.layer_types) & set(ATTENTION_TYPES):
            return 0
        w = self.window
        return min(w, seq_len) if w > 0 else seq_len

    @torch.inference_mode()
    def prefill(self, tokens: torch.Tensor, frontend_embeds: Optional[torch.Tensor] = None,
                extra_slots: int = 1) -> Tuple[torch.Tensor, Dict]:
        """tokens (B, S_tok) [after frontend embeddings (B, Lf, D)] ->
        ``(next-token logits (B, V), cache)``, the cache ready for
        :meth:`decode_step` at ``pos = Lf + S_tok``. Windowed attention
        caches are put in ring order (position % T); full-attention caches
        get ``extra_slots`` empty slots; int8 caches are quantized after
        that."""
        tokens = torch.as_tensor(tokens, device=self.device).long()
        fe = None if frontend_embeds is None else torch.as_tensor(frontend_embeds,
                                                                  device=self.device)
        h = self.embed(tokens, fe)
        S = h.shape[1]
        layers = []
        for layer in self.layers:
            h, cache = layer.prefill(h, self.window)
            layers.append(cache)
        logits = self.logits(h[:, -1:])[:, 0]
        T = self.attn_cache_len(S)
        ring = None
        if T:
            if self.window > 0:
                s = np.arange(T)
                ring = (S - 1) - ((S - 1 - s) % T)
                fix = lambda t: _ring_permute(t, S, T)
            else:
                ring = np.concatenate([np.arange(S), np.full(extra_slots, -1)])
                fix = lambda t: _pad_slots(t, extra_slots)
            ring = torch.as_tensor(ring, dtype=torch.int32, device=self.device)
            for i, cache in enumerate(layers):
                if "k" not in cache and "c_kv" not in cache:
                    continue
                cache = {name: fix(t) for name, t in cache.items()}
                if self.cfg.kv_quant == "int8":
                    k, k_scale = B.quantize_kv(cache["k"])
                    v, v_scale = B.quantize_kv(cache["v"])
                    cache = {"k": k, "v": v, "k_scale": k_scale, "v_scale": v_scale}
                layers[i] = cache
        return logits, {"pos": S, "ring": ring, "layers": layers}

    @torch.inference_mode()
    def decode_step(self, cache: Dict, tokens: torch.Tensor) -> Tuple[torch.Tensor, Dict]:
        """One token step: tokens (B, 1) -> ``(logits (B, V), cache)``. The
        cache returned is the one given, updated in place: each layer's
        leaves, the ring's slot for this token, and ``pos`` one on."""
        pos, ring = cache["pos"], cache["ring"]
        h = self.embed(torch.as_tensor(tokens, device=self.device).long())
        for layer, layer_cache in zip(self.layers, cache["layers"]):
            h = layer.decode(h, layer_cache, pos, self.window, ring)
        logits = self.logits(h)[:, 0]
        if ring is not None:
            ring[B.decode_slot(pos, ring.shape[0], self.window)] = pos
        cache["pos"] = pos + 1
        return logits, cache

    def init_cache(self, batch: int, cache_len: int, prefilled: int = 0) -> Dict:
        """A zeroed cache on the model's device, its ring positions
        consistent with ``prefilled`` tokens already in it."""
        cfg, dev = self.cfg, self.device
        T = self.attn_cache_len(cache_len)
        G, hd, K = cfg.num_kv_heads, cfg.head_dim, cfg.ssm_conv
        zeros = lambda shape, dtype: torch.zeros(shape, dtype=dtype, device=dev)
        layers = []
        for btype in cfg.layer_types:
            if btype in MLA_TYPES:
                layers.append({"c_kv": zeros((batch, T, cfg.kv_lora_rank), self.tok.dtype),
                               "k_pe": zeros((batch, T, cfg.qk_rope_head_dim), self.tok.dtype)})
            elif btype in ("attn", "moe"):
                if cfg.kv_quant == "int8":
                    layers.append({"k": zeros((batch, T, G, hd), torch.int8),
                                   "v": zeros((batch, T, G, hd), torch.int8),
                                   "k_scale": zeros((batch, T, G, 1), torch.float32),
                                   "v_scale": zeros((batch, T, G, 1), torch.float32)})
                else:
                    layers.append({"k": zeros((batch, T, G, hd), self.tok.dtype),
                                   "v": zeros((batch, T, G, hd), self.tok.dtype)})
            elif btype == "ssm":
                layers.append({"conv": zeros((batch, K - 1, cfg.d_inner), self.tok.dtype),
                               "h": zeros((batch, cfg.d_inner, cfg.ssm_state), torch.float32)})
            else:
                layers.append({"conv": zeros((batch, K - 1, cfg.rnn_width), self.tok.dtype),
                               "h": zeros((batch, cfg.rnn_width), torch.float32)})
        ring = None
        if T:
            s = np.arange(T)
            rp = (prefilled - 1) - ((prefilled - 1 - s) % T)
            rp = np.where((rp >= 0) & (rp < prefilled), rp, -1)
            ring = torch.as_tensor(rp, dtype=torch.int32, device=dev)
        return {"pos": prefilled, "ring": ring, "layers": layers}

    def loss(self, batch: Dict[str, torch.Tensor]):
        """Next-token LM loss: ``(loss, {"nll", "aux"})``. ``batch`` has
        tokens (B, S_tok) and, for frontend archs, frontend_embeds (B, Lf,
        D). ``nll`` is the mean f32 cross-entropy (padded vocab slots
        masked) of each position against the next token: without a frontend
        every position but the last; with one, the last frontend position
        and every token position but the last, against the tokens. MoE
        configs add ``0.01 * aux / num_layers`` to the loss. Where the batch
        is split over ranks (``batch`` this rank's block), the nll's sum and
        count are the global batch's, and the loss is the same on every
        rank."""
        cfg = self.cfg
        if cfg.router_scoring != "softmax":
            raise ValueError(f"training's aux loss of {cfg.router_scoring} routing is not "
                             f"computed: LM.loss does not take the block types "
                             f"{sorted(set(cfg.layer_types) & {'moe', 'mla_moe'})} ({cfg.name})")
        tokens = torch.as_tensor(batch["tokens"], device=self.device).long()
        fe = batch.get("frontend_embeds")
        fe = None if fe is None else torch.as_tensor(fe, device=self.device)
        tok = unshard(self.tok)                          # gathered once for both ends
        head = self._whole_head(tok)
        h = _embed(tok, tokens, fe)
        Bsz, S = h.shape[0], h.shape[1]
        Lf = 0 if fe is None else fe.shape[1]
        targets = torch.full((Bsz, S), IGNORE, dtype=torch.long, device=self.device)
        if Lf > 0:
            targets[:, Lf - 1: Lf - 1 + tokens.shape[1]] = tokens
        else:
            targets[:, : S - 1] = tokens[:, 1:]
        h, aux = self.backbone(h)
        if cfg.loss_chunk and cfg.loss_chunk < S:
            nloss, ncount = self._chunked_xent(h, targets, head)
        else:
            nloss, ncount = _xent_sum(self._logits(h, *head), targets, cfg.vocab_size)
        nll = batch_sum(nloss) / torch.clamp(batch_sum(ncount), min=1.0)
        loss = nll
        if cfg.num_experts:
            loss = nll + 0.01 * aux / max(len(cfg.layer_types), 1)
        return loss, {"nll": nll, "aux": aux}

    def _chunked_xent(self, h: torch.Tensor, targets: torch.Tensor, head):
        """``(sum of nll, count)`` over ``cfg.loss_chunk`` positions at a
        time, then the remainder."""
        c, S = self.cfg.loss_chunk, h.shape[1]
        n = S // c
        nloss = ncount = torch.zeros((), dtype=torch.float32, device=h.device)
        for i in range(n):
            l, k = _xent_sum(self._logits(h[:, i * c:(i + 1) * c], *head),
                             targets[:, i * c:(i + 1) * c], self.cfg.vocab_size)
            nloss, ncount = nloss + l, ncount + k
        if n * c < S:                                  # remainder
            l, k = _xent_sum(self._logits(h[:, n * c:], *head), targets[:, n * c:],
                             self.cfg.vocab_size)
            nloss, ncount = nloss + l, ncount + k
        return nloss, ncount


def _embed(tok: torch.Tensor, tokens: torch.Tensor,
           frontend_embeds: Optional[torch.Tensor]) -> torch.Tensor:
    """:meth:`LM.embed` on the whole embedding ``tok``."""
    h = tok[tokens]
    if frontend_embeds is not None:
        h = torch.cat([frontend_embeds.to(h.dtype), h], dim=1)
    return h


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


def _ring_permute(t: torch.Tensor, S: int, T: int) -> torch.Tensor:
    """Reorder a (B, T, ...) prefill cache leaf from sequence order (the
    last T positions) to ring order (position % T)."""
    s = np.arange(T)
    src = (S - 1) - ((S - 1 - s) % T) - (S - T)
    return t[:, torch.as_tensor(src, device=t.device)]


def _pad_slots(t: torch.Tensor, extra: int) -> torch.Tensor:
    """Append ``extra`` zero slots along the cache-time axis (dim 1)."""
    pad = torch.zeros((t.shape[0], extra, *t.shape[2:]), dtype=t.dtype, device=t.device)
    return torch.cat([t, pad], dim=1)


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
