"""Per-block-type functions (the port of ``repro/models/blocks.py``): over a
whole (B, S, D) sequence, for serving and training alike, optionally
making the block's prefill cache, and the one-token decode steps.

Each function takes the block's parameters as a name -> tensor mapping
(the JAX names). The full-sequence blocks return the block's output
(``moe_block`` also its aux load-balancing loss) and, with
``make_cache=True``, the cache after it; autograd differentiates them
(through the model kernels by their ``KernelFunction`` on the card). The
``*_block_decode`` functions take one (B, 1, D) step and the block's
cache and return the output and that cache, written in place: the new
token's k/v (int8 values and scales under ``cfg.kv_quant == "int8"``)
at its slot, the conv and recurrent states overwritten. The JAX package
returns a new cache from a functional update; copying a (B, T, G, hd)
cache per layer per step would dominate a decode step at width.

Caches hold, per attention layer, ``k``/``v`` (B, T, G, hd) in the model
dtype after RoPE (int8 with ``k_scale``/``v_scale`` (B, T, G, 1) f32 when
quantized), per latent-attention layer ``c_kv`` (B, T, kv_lora_rank) and
``k_pe`` (B, T, qk_rope_head_dim) (``models/mla.py``), per SSM layer
``conv`` (B, K-1, d_inner) and ``h`` (B, d_inner, N) f32, per recurrent
layer ``conv`` (B, K-1, Dr) and ``h`` (B, Dr) f32: the JAX leaves of one
layer, time on dim 1. The blocks take
whole parameters (a sharded model gathers them first,
``models/model.py``) and, under rules over a ``DeviceMesh``, this rank's
block of the batch: activations are not sharded, so the JAX package's
``constrain`` annotations have nothing to do here. The MoE FFN counts its
capacity over the global batch then, and the expert-parallel MoE runs over
the ``DeviceMesh`` (``_moe_ffn``).

The ``mla`` and ``mla_moe`` blocks (the port's own) are pre-norm blocks of
latent attention (``models/mla.py``) and a SwiGLU MLP, or a MoE FFN routed
as the configuration says (``router_scoring``) with its shared experts, a
SwiGLU of ``num_shared_experts`` x ``expert_d_ff`` under the weights
``wg``/``wu``/``wd``, added to the routed output (the profiler mark
``arm.moe.shared``).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.distributed.sharding import active_rules
from repro_torch.kernels import ops

from .attention import attention, direct_attention
from .config import ModelConfig
from .mla import mla_attention, mla_attention_decode
from .mlp import mlp_apply, rmsnorm, swiglu
from .moe import local_experts, moe_mlp, moe_mlp_ep
from .rglru import rglru_decode_step, rglru_gates, rglru_scan
from .rotary import apply_rope
from .ssm import causal_conv1d, conv_state as ssm_conv_state, selective_scan, ssm_decode_step

Cache = Dict[str, torch.Tensor]


def _attn_proj(params, x: torch.Tensor, cfg: ModelConfig):
    B, S, D = x.shape
    H, G, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    q = x @ params["wq"]
    k = x @ params["wk"]
    v = x @ params["wv"]
    if cfg.qkv_bias:
        q = q + params["bq"]
        k = k + params["bk"]
        v = v + params["bv"]
    return q.reshape(B, S, H, hd), k.reshape(B, S, G, hd), v.reshape(B, S, G, hd)


def attn_sublayer(params, x: torch.Tensor, cfg: ModelConfig, *, window: int,
                  make_cache: bool = False):
    """Full-sequence causal self-attention (RoPE on q and k). With
    ``make_cache``, ``(output, {"k", "v"})``: the keys and values of the
    last ``min(window or S, S)`` positions, in sequence order."""
    B, S, D = x.shape
    q, k, v = _attn_proj(params, x, cfg)
    positions = torch.arange(S, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = attention(q, k, v, causal=True, window=window, q_offset=0,
                    causal_buckets=cfg.attn_buckets)
    out = out.reshape(B, S, cfg.num_heads * cfg.head_dim) @ params["wo"]
    if not make_cache:
        return out
    W = min(window if window > 0 else S, S)
    return out, {"k": k[:, S - W:], "v": v[:, S - W:]}


KV_SCALE_EPS = 1e-8
_INV_127 = float(np.float32(1.0) / np.float32(127.0))


def quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, T, G, hd) -> (int8 values, (B, T, G, 1) f32 scales). The scale is
    ``max |x| * f32(1 / 127) + KV_SCALE_EPS``: the JAX package divides by
    127 under ``jit``, where XLA turns that division by a constant into a
    multiply by its f32 reciprocal. ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    x32 = x.float()
    scale = x32.abs().amax(dim=-1, keepdim=True) * _INV_127 + KV_SCALE_EPS
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def decode_slot(pos: int, T: int, window: int) -> int:
    """The cache slot of the token at ``pos``: a ring (``pos % T``) when
    windowed, else ``min(pos, T - 1)`` — past the free slots the last slot
    is overwritten, as in the JAX package."""
    return pos % T if window > 0 else min(pos, T - 1)


def attn_sublayer_decode(params, x: torch.Tensor, cfg: ModelConfig, cache: Cache, pos: int,
                         window: int, ring_pos: torch.Tensor):
    """One token (B, 1, D) at absolute position ``pos`` against the cache:
    its k/v written at :func:`decode_slot` in place, then direct attention
    over every slot whose position (``ring_pos``, (T,) int32, the positions
    before this write; -1 for an empty slot) is valid. Returns ``(output,
    cache)``."""
    B = x.shape[0]
    T = cache["k"].shape[1]
    q, k, v = _attn_proj(params, x, cfg)
    p = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, p, cfg.rope_theta)
    k = apply_rope(k, p, cfg.rope_theta)
    slot = decode_slot(pos, T, window)
    if cfg.kv_quant == "int8":
        for name, t in (("k", k), ("v", v)):
            tq, ts = quantize_kv(t)
            cache[name][:, slot] = tq[:, 0]
            cache[f"{name}_scale"][:, slot] = ts[:, 0]
        k_cache = dequantize_kv(cache["k"], cache["k_scale"], k.dtype)
        v_cache = dequantize_kv(cache["v"], cache["v_scale"], v.dtype)
    else:
        cache["k"][:, slot] = k[:, 0]
        cache["v"][:, slot] = v[:, 0]
        k_cache, v_cache = cache["k"], cache["v"]
    k_pos = ring_pos.clone()
    k_pos[slot] = pos
    kv_valid = (k_pos >= 0) & (k_pos <= pos)
    out = direct_attention(q, k_cache, v_cache, causal=True, window=window, q_offset=pos,
                           k_positions=k_pos, kv_valid=kv_valid[None].expand(B, T))
    return out.reshape(B, 1, cfg.num_heads * cfg.head_dim) @ params["wo"], cache


def attn_block(params, x: torch.Tensor, cfg: ModelConfig, *, window: int,
               make_cache: bool = False):
    """The attention block's output; with ``make_cache``, ``(output, cache)``."""
    h = attn_sublayer(params, rmsnorm(x, params["ln1"], cfg.norm_eps), cfg, window=window,
                      make_cache=make_cache)
    h, cache = h if make_cache else (h, None)
    x = x + h
    x = x + mlp_apply(rmsnorm(x, params["ln2"], cfg.norm_eps), params, cfg.mlp_variant)
    return (x, cache) if make_cache else x


def attn_block_decode(params, x: torch.Tensor, cache: Cache, cfg: ModelConfig, pos: int, *,
                      window: int, ring_pos: torch.Tensor):
    h, cache = attn_sublayer_decode(params, rmsnorm(x, params["ln1"], cfg.norm_eps), cfg,
                                    cache, pos, window, ring_pos)
    x = x + h
    x = x + mlp_apply(rmsnorm(x, params["ln2"], cfg.norm_eps), params, cfg.mlp_variant)
    return x, cache


def _moe_ffn(params, x: torch.Tensor, cfg: ModelConfig):
    """The MoE FFN over every token of ``x`` (B, S, D): ``(output, aux)``;
    the capacity counts these B * S tokens, or under rules over a
    ``DeviceMesh`` those of the global batch (``moe_mlp``). Under ``cfg.moe_ep`` with
    active sharding rules whose mesh has a ``"model"`` axis, the
    expert-parallel dispatch over that mesh (a ``DeviceMesh``; ``x`` is
    this rank's batch shard; each rank takes its rows of the full expert
    weights)."""
    B, S, D = x.shape
    flat = rmsnorm(x, params["ln2"], cfg.norm_eps).reshape(B * S, D)
    rules = active_rules()
    if cfg.moe_ep and rules is not None and "model" in rules.sizes:
        mesh = rules.mesh
        if not hasattr(mesh, "get_group"):
            raise ValueError("cfg.moe_ep exchanges tokens between the processes of a "
                             "torch.distributed DeviceMesh; the active rules' mesh is a layout "
                             "with no processes")
        E = cfg.num_experts
        ew = [local_experts(params.get(n), E, mesh) for n in ("ewg", "ewu", "ewd")]
        out, aux = moe_mlp_ep(flat, params["router"], *ew, cfg.experts_per_token,
                              cfg.expert_capacity_factor, mesh)
    else:
        out, aux = moe_mlp(flat, params["router"], params["ewg"], params.get("ewu"),
                           params["ewd"], cfg.experts_per_token, cfg.expert_capacity_factor,
                           **_router_options(params, cfg))
    if cfg.num_shared_experts:
        with trace.mark("arm.moe.shared"):
            out = out + swiglu(flat, params["wg"], params["wu"], params["wd"])
    return out.reshape(B, S, D), aux


def _router_options(params, cfg: ModelConfig) -> Dict:
    """``moe_mlp``'s routing keywords: none under softmax scoring (its
    default), else the sigmoid router's bias and scaling."""
    if cfg.router_scoring == "softmax":
        return {}
    return {"scoring": cfg.router_scoring, "bias": params["router_bias"],
            "scaling": cfg.routed_scaling}


def moe_block(params, x: torch.Tensor, cfg: ModelConfig, *, window: int,
              make_cache: bool = False):
    """Attention, then a top-k MoE FFN: ``(output, aux loss)``; with
    ``make_cache``, ``(output, aux loss, cache)``."""
    h = attn_sublayer(params, rmsnorm(x, params["ln1"], cfg.norm_eps), cfg, window=window,
                      make_cache=make_cache)
    h, cache = h if make_cache else (h, None)
    x = x + h
    out, aux = _moe_ffn(params, x, cfg)
    return (x + out, aux, cache) if make_cache else (x + out, aux)


def moe_block_decode(params, x: torch.Tensor, cache: Cache, cfg: ModelConfig, pos: int, *,
                     window: int, ring_pos: torch.Tensor):
    """One step of the MoE block: the B decode tokens are routed together,
    and the capacity counts those B tokens."""
    h, cache = attn_sublayer_decode(params, rmsnorm(x, params["ln1"], cfg.norm_eps), cfg,
                                    cache, pos, window, ring_pos)
    x = x + h
    out, _ = _moe_ffn(params, x, cfg)
    return x + out, cache


def mla_block(params, x: torch.Tensor, cfg: ModelConfig, *, window: int,
              make_cache: bool = False):
    """Latent attention, then a SwiGLU MLP; with ``make_cache``,
    ``(output, cache)``."""
    h = mla_attention(params, rmsnorm(x, params["ln1"], cfg.norm_eps), cfg, window=window,
                      make_cache=make_cache)
    h, cache = h if make_cache else (h, None)
    x = x + h
    x = x + mlp_apply(rmsnorm(x, params["ln2"], cfg.norm_eps), params, "swiglu")
    return (x, cache) if make_cache else x


def mla_moe_block(params, x: torch.Tensor, cfg: ModelConfig, *, window: int,
                  make_cache: bool = False):
    """Latent attention, then the MoE FFN with its shared experts:
    ``(output, aux)`` (aux None under sigmoid scoring); with
    ``make_cache``, ``(output, aux, cache)``."""
    h = mla_attention(params, rmsnorm(x, params["ln1"], cfg.norm_eps), cfg, window=window,
                      make_cache=make_cache)
    h, cache = h if make_cache else (h, None)
    x = x + h
    out, aux = _moe_ffn(params, x, cfg)
    return (x + out, aux, cache) if make_cache else (x + out, aux)


def _mla_decode(params, x: torch.Tensor, cache: Cache, cfg: ModelConfig, pos: int,
                window: int, ring_pos: torch.Tensor):
    xn = rmsnorm(x, params["ln1"], cfg.norm_eps)
    slot = decode_slot(pos, cache["c_kv"].shape[1], window)
    h, cache = mla_attention_decode(params, xn, cfg, cache, pos, slot, window, ring_pos)
    return x + h, cache


def mla_block_decode(params, x: torch.Tensor, cache: Cache, cfg: ModelConfig, pos: int, *,
                     window: int, ring_pos: torch.Tensor):
    x, cache = _mla_decode(params, x, cache, cfg, pos, window, ring_pos)
    return x + mlp_apply(rmsnorm(x, params["ln2"], cfg.norm_eps), params, "swiglu"), cache


def mla_moe_block_decode(params, x: torch.Tensor, cache: Cache, cfg: ModelConfig, pos: int, *,
                         window: int, ring_pos: torch.Tensor):
    """One step: the B decode tokens are routed together, and the capacity
    counts those B tokens."""
    x, cache = _mla_decode(params, x, cache, cfg, pos, window, ring_pos)
    out, _ = _moe_ffn(params, x, cfg)
    return x + out, cache


def _ssm_inner(params, xn: torch.Tensor, cfg: ModelConfig, conv_state: Optional[torch.Tensor],
               h_state: Optional[torch.Tensor]):
    """Mamba mixer over S >= 1 steps from ``conv_state`` and ``h_state``
    (None: zeros): ``(output, conv state (B, K-1, Din), h (B, Din, N))``.
    One step from a given ``h_state`` is the plain decode step (``h_state``
    updated in place), as in the JAX package; otherwise the fused scan."""
    Din, N, R = cfg.d_inner, cfg.ssm_state, cfg.ssm_dt_rank
    S = xn.shape[1]
    xpart, z = (xn @ params["w_in"]).split(Din, dim=-1)          # (B,S,Din) each
    xconv = ops.causal_conv1d(xpart, params["conv_w"], params["conv_b"], conv_state, silu=True)
    new_conv = ssm_conv_state(xpart, params["conv_w"].shape[1], conv_state)
    dt_r, Bmat, Cmat = (xconv @ params["w_x"]).split([R, N, N], dim=-1)
    dt = F.softplus(dt_r @ params["w_dt"] + params["b_dt"])
    A = -torch.exp(params["a_log"].float())                      # (Din,N), negative
    if S == 1 and h_state is not None:
        y, h_new = ssm_decode_step(xconv[:, 0], dt[:, 0], A, Bmat[:, 0], Cmat[:, 0],
                                   params["d_skip"], h_state)
        y = y[:, None]
    else:
        y, h_new = selective_scan(xconv, dt, A, Bmat, Cmat, params["d_skip"], h0=h_state,
                                  chunk=cfg.ssm_chunk)
    y = y * F.silu(z)
    return y @ params["w_out"], new_conv, h_new


def ssm_block(params, x: torch.Tensor, cfg: ModelConfig, *, make_cache: bool = False):
    """The Mamba block's output; with ``make_cache``, ``(output, {"conv",
    "h"})``. The JAX package scans from a zero ``h0`` when it makes a cache
    and from none otherwise, the same numbers; only its one-token prefill
    differs, taking the decode step from zeros, and so does this one."""
    h0 = None
    if make_cache and x.shape[1] == 1:
        h0 = torch.zeros((x.shape[0], cfg.d_inner, cfg.ssm_state), dtype=torch.float32,
                         device=x.device)
    out, new_conv, h_new = _ssm_inner(params, rmsnorm(x, params["ln"], cfg.norm_eps), cfg,
                                      None, h0)
    if not make_cache:
        return x + out
    return x + out, {"conv": new_conv.contiguous(), "h": h_new}


def ssm_block_decode(params, x: torch.Tensor, cache: Cache, cfg: ModelConfig, pos: int):
    out, new_conv, _ = _ssm_inner(params, rmsnorm(x, params["ln"], cfg.norm_eps), cfg,
                                  cache["conv"], cache["h"])
    cache["conv"].copy_(new_conv)
    return x + out, cache


def rec_block(params, x: torch.Tensor, cfg: ModelConfig, *, make_cache: bool = False):
    """RG-LRU recurrent block (Griffin): gated dual-branch. With
    ``make_cache``, ``(output, {"conv", "h"})``, ``h`` the scan's
    ``h_last``."""
    xn = rmsnorm(x, params["ln"], cfg.norm_eps)
    y = F.gelu(xn @ params["wy"], approximate="tanh")
    xb = xn @ params["wx"]                                        # (B,S,Dr)
    xb, new_conv = causal_conv1d(xb, params["conv_w"], params["conv_b"], None)
    log_a, gated = rglru_gates(
        xb, params["wr"], params["wi"], params["br"], params["bi"], params["lam"]
    )
    h, h_last = rglru_scan(log_a, gated)
    x = x + (h.to(x.dtype) * y) @ params["w_out"]
    x = x + mlp_apply(rmsnorm(x, params["ln2"], cfg.norm_eps), params, cfg.mlp_variant)
    if not make_cache:
        return x
    return x, {"conv": new_conv.contiguous(), "h": h_last}


def rec_block_decode(params, x: torch.Tensor, cache: Cache, cfg: ModelConfig, pos: int):
    xn = rmsnorm(x, params["ln"], cfg.norm_eps)
    y = F.gelu(xn @ params["wy"], approximate="tanh")
    xb = xn @ params["wx"]
    xb, new_conv = causal_conv1d(xb, params["conv_w"], params["conv_b"], cache["conv"])
    cache["conv"].copy_(new_conv)
    h_out, _ = rglru_decode_step(xb[:, 0], params["wr"], params["wi"], params["br"],
                                 params["bi"], params["lam"], cache["h"])
    x = x + (h_out[:, None] * y) @ params["w_out"]
    return x + mlp_apply(rmsnorm(x, params["ln2"], cfg.norm_eps), params, cfg.mlp_variant), cache
