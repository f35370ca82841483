"""Per-block-type functions over a whole (B, S, D) sequence (the port of
``repro/models/blocks.py``'s full-sequence blocks), for serving and
training alike.

Each function takes the block's parameters as a name -> tensor mapping
(the JAX names) and returns the block's output (``moe_block`` also its
aux load-balancing loss); autograd differentiates it (through the model
kernels by their ``KernelFunction`` on the card). Prefill caches, the
one-token decode steps (``moe_block_decode`` among them) and the int8 KV
cache wait for the decode slice; the ``constrain`` sharding annotations
and the expert-parallel MoE of the JAX package have no counterpart on one
card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .attention import attention
from .config import ModelConfig
from .mlp import mlp_apply, rmsnorm
from .moe import moe_mlp
from .rglru import rglru_gates, rglru_scan
from .rotary import apply_rope
from .ssm import causal_conv1d, selective_scan


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


def attn_sublayer(params, x: torch.Tensor, cfg: ModelConfig, *, window: int) -> torch.Tensor:
    """Full-sequence causal self-attention (RoPE on q and k)."""
    B, S, D = x.shape
    q, k, v = _attn_proj(params, x, cfg)
    positions = torch.arange(S, device=x.device)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    out = attention(q, k, v, causal=True, window=window, q_offset=0,
                    causal_buckets=cfg.attn_buckets)
    return out.reshape(B, S, cfg.num_heads * cfg.head_dim) @ params["wo"]


def attn_block(params, x: torch.Tensor, cfg: ModelConfig, *, window: int) -> torch.Tensor:
    x = x + attn_sublayer(params, rmsnorm(x, params["ln1"], cfg.norm_eps), cfg, window=window)
    return x + mlp_apply(rmsnorm(x, params["ln2"], cfg.norm_eps), params, cfg.mlp_variant)


def moe_block(params, x: torch.Tensor, cfg: ModelConfig, *, window: int):
    """Attention, then a top-k MoE FFN: ``(output, aux loss)``."""
    x = x + attn_sublayer(params, rmsnorm(x, params["ln1"], cfg.norm_eps), cfg, window=window)
    B, S, D = x.shape
    flat = rmsnorm(x, params["ln2"], cfg.norm_eps).reshape(B * S, D)
    out, aux = moe_mlp(flat, params["router"], params["ewg"], params.get("ewu"), params["ewd"],
                       cfg.experts_per_token, cfg.expert_capacity_factor)
    return x + out.reshape(B, S, D), aux


def _ssm_inner(params, xn: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Mamba mixer over the whole sequence from a zero state."""
    Din, N, R = cfg.d_inner, cfg.ssm_state, cfg.ssm_dt_rank
    xpart, z = (xn @ params["w_in"]).split(Din, dim=-1)          # (B,S,Din) each
    xconv, _ = causal_conv1d(xpart, params["conv_w"], params["conv_b"], None)
    xconv = F.silu(xconv)
    dt_r, Bmat, Cmat = (xconv @ params["w_x"]).split([R, N, N], dim=-1)
    dt = F.softplus(dt_r @ params["w_dt"] + params["b_dt"])
    A = -torch.exp(params["a_log"].float())                      # (Din,N), negative
    y, _ = selective_scan(xconv, dt, A, Bmat, Cmat, params["d_skip"], h0=None,
                          chunk=cfg.ssm_chunk)
    y = y * F.silu(z)
    return y @ params["w_out"]


def ssm_block(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    return x + _ssm_inner(params, rmsnorm(x, params["ln"], cfg.norm_eps), cfg)


def rec_block(params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """RG-LRU recurrent block (Griffin): gated dual-branch."""
    xn = rmsnorm(x, params["ln"], cfg.norm_eps)
    y = F.gelu(xn @ params["wy"], approximate="tanh")
    xb = xn @ params["wx"]                                        # (B,S,Dr)
    xb, _ = causal_conv1d(xb, params["conv_w"], params["conv_b"], None)
    log_a, gated = rglru_gates(
        xb, params["wr"], params["wi"], params["br"], params["bi"], params["lam"]
    )
    h, _ = rglru_scan(log_a, gated)
    x = x + (h.to(x.dtype) * y) @ params["w_out"]
    return x + mlp_apply(rmsnorm(x, params["ln2"], cfg.norm_eps), params, cfg.mlp_variant)
