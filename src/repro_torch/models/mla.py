"""Latent attention (MLA, DeepSeek-V2/V3) of the ``mla`` and ``mla_moe``
blocks: the port's own, the JAX package has none.

Queries at full rank: ``q = x wq``, per head ``qk_nope_head_dim`` columns
and ``qk_rope_head_dim`` with RoPE. Keys and values come from one latent:
``x wkv_a`` gives ``c_kv`` (``kv_lora_rank``), RMSNormed by ``kv_norm``, and
``k_pe`` (``qk_rope_head_dim``), rotated and shared by every head;
``c_kv wkv_b`` gives each head's ``k_nope`` and v (``v_head_dim``). The
scores take ``1 / sqrt(qk_nope_head_dim + qk_rope_head_dim)``, as
published without ``rope_scaling``; the output is ``attn(q, k, v) wo``.

RoPE rotates the two halves of q_pe and k_pe (:func:`apply_rope`), as every
block of the port does; the published checkpoint's interleaved layout is a
fixed permutation of those weight columns.

Prefill runs the attention through the ``flash_attention`` kernel on the
card (v zero-padded to q/k's head dim in its wrapper). The cache is the
latent, ``c_kv`` (B, T, kv_lora_rank) normed and ``k_pe`` (B, T,
qk_rope_head_dim) rotated, in the model dtype: 576 values a position at
Moonlight's widths, against 2 H 128 = 4096 each for k and v expanded. A
decode step writes its token's latent at its slot and expands the whole
cache through ``wkv_b`` (plain torch, as the port's decode is).

Under the profiler the projections (q, ``wkv_a``, the latent norm,
``wkv_b``, RoPE) are the mark ``arm.mla.project`` and the attention the
mark ``arm.mla.attend`` (:func:`repro_torch.trace.mark`).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from repro_torch import trace

from .attention import attention, direct_attention
from .config import ModelConfig
from .mlp import rmsnorm
from .rotary import apply_rope


def _project(params, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor):
    """``(q (B, S, H, dn + dr), c_kv (B, S, r) normed, k_pe (B, S, dr)
    rotated)`` of the tokens ``x`` at ``positions``."""
    B, S, _ = x.shape
    H, dn, dr, r = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
    q_nope, q_pe = (x @ params["wq"]).view(B, S, H, dn + dr).split([dn, dr], dim=-1)
    q = torch.cat([q_nope, apply_rope(q_pe, positions, cfg.rope_theta)], dim=-1)
    c_kv, k_pe = (x @ params["wkv_a"]).split([r, dr], dim=-1)
    c_kv = rmsnorm(c_kv, params["kv_norm"], cfg.norm_eps)
    k_pe = apply_rope(k_pe[:, :, None], positions, cfg.rope_theta)[:, :, 0]
    return q, c_kv, k_pe


def _expand(params, c_kv: torch.Tensor, k_pe: torch.Tensor, cfg: ModelConfig):
    """Every head's keys (B, T, H, dn + dr) and values (B, T, H, dv) from
    the latent (B, T, r) and the shared rotated k_pe (B, T, dr)."""
    B, T, _ = c_kv.shape
    H, dn, dr, dv = cfg.num_heads, cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
    k_nope, v = (c_kv @ params["wkv_b"]).view(B, T, H, dn + dv).split([dn, dv], dim=-1)
    k = torch.cat([k_nope, k_pe[:, :, None].expand(B, T, H, dr)], dim=-1)
    return k, v


def mla_attention(params, x: torch.Tensor, cfg: ModelConfig, *, window: int,
                  make_cache: bool = False):
    """Full-sequence causal latent attention of ``x`` (B, S, D), normed by
    the caller. With ``make_cache``, ``(output, {"c_kv", "k_pe"})``: the
    latent of the last ``min(window or S, S)`` positions, in sequence
    order."""
    B, S, _ = x.shape
    positions = torch.arange(S, device=x.device)
    with trace.mark("arm.mla.project"):
        q, c_kv, k_pe = _project(params, x, cfg, positions)
        k, v = _expand(params, c_kv, k_pe, cfg)
    with trace.mark("arm.mla.attend"):
        out = attention(q, k, v, causal=True, window=window, q_offset=0,
                        causal_buckets=cfg.attn_buckets)
    out = out.reshape(B, S, cfg.num_heads * cfg.v_head_dim) @ params["wo"]
    if not make_cache:
        return out
    W = min(window if window > 0 else S, S)
    return out, {"c_kv": c_kv[:, S - W:], "k_pe": k_pe[:, S - W:]}


def mla_attention_decode(params, x: torch.Tensor, cfg: ModelConfig, cache: Dict[str, torch.Tensor],
                         pos: int, slot: int, window: int,
                         ring_pos: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """One token (B, 1, D), normed by the caller, at absolute position
    ``pos``: its latent written at cache slot ``slot`` in place, then
    direct attention over every slot whose position (``ring_pos``, (T,)
    int32, the positions before this write; -1 empty) is valid. Returns
    ``(output, cache)``."""
    B, T = x.shape[0], cache["c_kv"].shape[1]
    p = torch.full((1,), pos, dtype=torch.int32, device=x.device)
    q, c_kv, k_pe = _project(params, x, cfg, p)
    cache["c_kv"][:, slot] = c_kv[:, 0]
    cache["k_pe"][:, slot] = k_pe[:, 0]
    k, v = _expand(params, cache["c_kv"], cache["k_pe"], cfg)
    k_pos = ring_pos.clone()
    k_pos[slot] = pos
    kv_valid = (k_pos >= 0) & (k_pos <= pos)
    out = direct_attention(q, k, v, causal=True, window=window, q_offset=pos,
                           k_positions=k_pos, kv_valid=kv_valid[None].expand(B, T))
    return out.reshape(B, 1, cfg.num_heads * cfg.v_head_dim) @ params["wo"], cache
