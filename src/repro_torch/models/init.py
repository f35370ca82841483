"""Parameter initialization (the port of ``repro/models/init.py``).

:func:`init_params` makes the JAX package's parameter tree — same names,
shapes, dtypes and distributions, each segment's blocks stacked over a
leading ``repeats`` axis — from an explicit ``torch.Generator``. The draws
are torch's, not jax's: the two packages agree in distribution, not in
values (tests that compare the packages carry JAX-made weights across with
``repro_torch.convert``). Every tensor is drawn on the target device
straight into its target dtype, a chunk of f32 normals at a time, so a
9.4 B-parameter bf16 model never exists in f32. On the ``meta`` device
(shapes and dtypes only, nothing allocated) nothing is drawn and ``gen``
may be None.

:func:`unstack_params` turns that tree into the port's per-layer layout,
the one :class:`repro_torch.models.model.LM` takes::

    {"embed": {"tok"}, "final_norm", ["head": {"w"}], "layers": [{name: tensor}, ...]}

with the layers in the JAX order: segments, then repeats, then the pattern
unit.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from .config import ModelConfig

_CHUNK = 1 << 24          # f32 normals drawn at a time (64 MB)


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def padded_vocab(cfg: ModelConfig, pad_to: int = 256) -> int:
    return ((cfg.vocab_size + pad_to - 1) // pad_to) * pad_to


def _normal(shape, std: float, dtype, gen: Optional[torch.Generator],
            dev: torch.device) -> torch.Tensor:
    """N(0, std^2) of ``shape`` in ``dtype`` on ``dev`` (the generator's
    device), drawn in f32 chunks and rounded into place; on ``meta`` an
    empty tensor of that shape."""
    out = torch.empty(shape, dtype=dtype, device=dev)
    if dev.type == "meta":
        return out
    flat = out.view(-1)
    for i in range(0, flat.numel(), _CHUNK):
        n = min(_CHUNK, flat.numel() - i)
        draw = torch.randn(n, generator=gen, dtype=torch.float32, device=gen.device)
        flat[i:i + n].copy_(draw.mul_(std))
    return out


def init_block_params(gen: Optional[torch.Generator], btype: str, cfg: ModelConfig, stack: int,
                      dev: torch.device) -> Dict:
    """Init one block type with a leading ``stack`` (repeats) dimension on
    ``dev`` (the generator's device; ``gen`` is None on ``meta``)."""
    D, F = cfg.d_model, cfg.d_ff
    H, G, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    dt = _dtype(cfg)
    p: Dict = {}

    def dense(shape, fan_in):
        return _normal((stack, *shape), 1.0 / math.sqrt(fan_in), dt, gen, dev)

    def zeros(shape, dtype=torch.float32):
        return torch.zeros((stack, *shape), dtype=dtype, device=dev)

    if btype in ("attn", "moe"):
        p["ln1"] = zeros((D,))
        p["wq"] = dense((D, H * hd), D)
        p["wk"] = dense((D, G * hd), D)
        p["wv"] = dense((D, G * hd), D)
        p["wo"] = dense((H * hd, D), H * hd)
        if cfg.qkv_bias:
            p["bq"] = zeros((H * hd,), dt)
            p["bk"] = zeros((G * hd,), dt)
            p["bv"] = zeros((G * hd,), dt)
        p["ln2"] = zeros((D,))
        gated = cfg.mlp_variant == "swiglu"
        if btype == "attn":
            p["wg"] = dense((D, F), D)
            if gated:
                p["wu"] = dense((D, F), D)
            p["wd"] = dense((F, D), F)
        else:
            E = cfg.num_experts
            p["router"] = dense((D, E), D)
            p["ewg"] = dense((E, D, F), D)
            if gated:
                p["ewu"] = dense((E, D, F), D)
            p["ewd"] = dense((E, F, D), F)
    elif btype in ("mla", "mla_moe"):
        r, dn, dr, dv = cfg.kv_lora_rank, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        p["ln1"] = zeros((D,))
        p["wq"] = dense((D, H * (dn + dr)), D)
        p["wkv_a"] = dense((D, r + dr), D)
        p["kv_norm"] = zeros((r,))
        p["wkv_b"] = dense((r, H * (dn + dv)), r)
        p["wo"] = dense((H * dv, D), H * dv)
        p["ln2"] = zeros((D,))
        if btype == "mla":
            p["wg"] = dense((D, F), D)
            p["wu"] = dense((D, F), D)
            p["wd"] = dense((F, D), F)
        else:
            E, Fe = cfg.num_experts, cfg.expert_width
            p["router"] = dense((D, E), D)
            if cfg.router_scoring == "sigmoid":
                p["router_bias"] = zeros((E,))          # trained from 0, as published
            p["ewg"] = dense((E, D, Fe), D)
            p["ewu"] = dense((E, D, Fe), D)
            p["ewd"] = dense((E, Fe, D), Fe)
            Fs = cfg.num_shared_experts * Fe
            if Fs:
                p["wg"] = dense((D, Fs), D)
                p["wu"] = dense((D, Fs), D)
                p["wd"] = dense((Fs, D), Fs)
    elif btype == "ssm":
        Din, N, R, K = cfg.d_inner, cfg.ssm_state, cfg.ssm_dt_rank, cfg.ssm_conv
        p["ln"] = zeros((D,))
        p["w_in"] = dense((D, 2 * Din), D)
        p["conv_w"] = dense((Din, K), K)
        p["conv_b"] = zeros((Din,))
        p["w_x"] = dense((Din, R + 2 * N), Din)
        p["w_dt"] = dense((R, Din), R)
        p["b_dt"] = zeros((Din,))
        # S4-style A init: -[1..N] per channel, stored as log
        a = torch.arange(1, N + 1, dtype=torch.float32, device=dev)
        p["a_log"] = torch.log(a).expand(stack, Din, N).contiguous()
        p["d_skip"] = torch.ones((stack, Din), dtype=torch.float32, device=dev)
        p["w_out"] = dense((Din, D), Din)
    elif btype == "rec":
        Dr, K = cfg.rnn_width, cfg.ssm_conv
        p["ln"] = zeros((D,))
        p["wy"] = dense((D, Dr), D)
        p["wx"] = dense((D, Dr), D)
        p["conv_w"] = dense((Dr, K), K)
        p["conv_b"] = zeros((Dr,))
        p["wr"] = dense((Dr, Dr), Dr)
        p["br"] = zeros((Dr,))
        p["wi"] = dense((Dr, Dr), Dr)
        p["bi"] = zeros((Dr,))
        # lambda init so decay a^c is in (0.9, 0.999) as in Griffin
        u = (torch.empty((stack, Dr), dtype=torch.float32, device=dev) if dev.type == "meta" else
             torch.rand((stack, Dr), generator=gen, dtype=torch.float32, device=dev))
        u = u * (0.999 - 0.9) + 0.9
        p["lam"] = torch.log(torch.exp(-torch.log(u) / 8.0) - 1.0)  # softplus^-1
        p["w_out"] = dense((Dr, D), Dr)
        p["ln2"] = zeros((D,))
        p["wg"] = dense((D, F), D)
        if cfg.mlp_variant == "swiglu":
            p["wu"] = dense((D, F), D)
        p["wd"] = dense((F, D), F)
    else:
        raise ValueError(btype)
    return p


def init_params(gen: Optional[torch.Generator], cfg: ModelConfig, device=None) -> Dict:
    """Full parameter tree in the JAX layout (embed + per-segment stacked
    blocks + head), on ``device`` (default ``gen.device``; ``gen`` may be
    None on ``meta``)."""
    V = padded_vocab(cfg)
    D = cfg.d_model
    dt = _dtype(cfg)
    dev = torch.device(device) if device is not None else gen.device
    params: Dict = {
        "embed": {"tok": _normal((V, D), 0.02, dt, gen, dev)},
        "final_norm": torch.zeros((D,), dtype=torch.float32, device=dev),
    }
    if not cfg.tie_embeddings:
        params["head"] = {"w": _normal((D, V), 1.0 / math.sqrt(D), dt, gen, dev)}
    for si, (unit, repeats) in enumerate(cfg.segments()):
        params[f"seg{si}"] = {
            f"u{j}": init_block_params(gen, btype, cfg, repeats, dev)
            for j, btype in enumerate(unit)
        }
    return params


def unstack_params(params: Dict, cfg: ModelConfig) -> Dict:
    """The JAX-layout tree as the port's per-layer layout (views, no copy)."""
    layers = []
    for si, (unit, repeats) in enumerate(cfg.segments()):
        seg = params[f"seg{si}"]
        for r in range(repeats):
            for j in range(len(unit)):
                layers.append({name: t[r] for name, t in seg[f"u{j}"].items()})
    out = {"embed": {"tok": params["embed"]["tok"]}, "final_norm": params["final_norm"],
           "layers": layers}
    if "head" in params:
        out["head"] = {"w": params["head"]["w"]}
    return out
