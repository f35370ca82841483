"""Model configuration for every architecture family in the pool.

A model is a sequence of *blocks*; the per-layer block type is derived from
``block_pattern`` cycled over ``num_layers``. The port's copy of
``repro/models/config.py`` (plain data, no framework): ``segments()`` still
names the JAX parameter layout — the pattern unit and its repeats — which
the port's per-layer modules follow in the same order; the scan over
repeats has no counterpart in the port, whose layers run as a Python loop.

Block types:
  ``attn``   dense attention block (GQA + RoPE [+ sliding window]) + SwiGLU
  ``moe``    attention block whose MLP is a top-k mixture of experts
  ``ssm``    Mamba-1 selective-state-space block (attention-free)
  ``rec``    RG-LRU recurrent block (RecurrentGemma / Griffin)
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int                  # query heads; 0 for attention-free archs
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # default d_model // num_heads
    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    expert_capacity_factor: float = 1.25
    moe_ep: bool = False            # shard_map expert parallelism (perf #2)
    # --- SSM (Mamba-1) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_dt_rank: int = 0            # default ceil(d_model / 16)
    ssm_chunk: int = 256            # chunked-scan length
    # --- RG-LRU (hybrid) ---
    rnn_width: int = 0              # default d_model
    # --- attention details ---
    window: int = 0                 # sliding-window size; 0 = full attention
    local_window: int = 2048        # window of 'attn' blocks in hybrid pattern
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    mlp_variant: str = "swiglu"     # swiglu (3 mats) | gelu (2 mats)
    attn_buckets: int = 0           # >0: prefix-bucketed causal scan (perf #1)
    kv_quant: str = "none"          # none | int8 (decode KV cache, perf #3)
    block_pattern: Tuple[str, ...] = ("attn",)
    # --- embeddings / head ---
    tie_embeddings: bool = True
    norm_eps: float = 1e-6
    # --- frontend stub (vlm / audio) ---
    frontend: str = "none"          # none | vision | audio
    frontend_len: int = 0           # prepended embedding positions
    # --- numerics / training ---
    dtype: str = "bfloat16"         # activation/param dtype for the big runs
    remat: bool = True
    num_microbatches: int = 1
    loss_chunk: int = 0             # 0 = unchunked softmax-xent
    logits_softcap: float = 0.0

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.ssm_dt_rank == 0 and self.ssm_state > 0:
            object.__setattr__(self, "ssm_dt_rank", math.ceil(self.d_model / 16))
        if self.rnn_width == 0 and "rec" in self.block_pattern:
            object.__setattr__(self, "rnn_width", self.d_model)

    # ------------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def layer_types(self) -> List[str]:
        pat = self.block_pattern
        return [pat[i % len(pat)] for i in range(self.num_layers)]

    def segments(self) -> List[Tuple[Tuple[str, ...], int]]:
        """Split layers into (pattern_unit, n_repeats) scan segments.

        ``num_layers = 38`` with pattern (rec, rec, attn) becomes
        ``[(('rec','rec','attn'), 12), (('rec','rec'), 1)]``.
        """
        unit = self.block_pattern
        u = len(unit)
        full, rem = divmod(self.num_layers, u)
        segs: List[Tuple[Tuple[str, ...], int]] = []
        if full:
            segs.append((tuple(unit), full))
        if rem:
            segs.append((tuple(unit[:rem]), 1))
        return segs

    # ------------------------------------------------------------------
    def param_count(self) -> int:
        """Exact parameter count (embedding included once if tied)."""
        D, F, V = self.d_model, self.d_ff, self.vocab_size
        H, G, hd = self.num_heads, self.num_kv_heads, self.head_dim
        total = V * D                                   # embed
        if not self.tie_embeddings:
            total += V * D
        total += D                                      # final norm
        for t in self.layer_types:
            if t in ("attn", "moe"):
                total += D                              # ln1
                total += D * (H * hd) + 2 * D * (G * hd) + (H * hd) * D
                if self.qkv_bias:
                    total += H * hd + 2 * G * hd
                total += D                              # ln2
                n_mats = 3 if self.mlp_variant == "swiglu" else 2
                if t == "attn":
                    total += n_mats * D * F
                else:
                    total += D * self.num_experts       # router
                    total += self.num_experts * n_mats * D * F
            elif t == "ssm":
                Din, N, R = self.d_inner, self.ssm_state, self.ssm_dt_rank
                total += D                              # ln
                total += D * 2 * Din                    # in_proj
                total += Din * self.ssm_conv + Din      # conv
                total += Din * (R + 2 * N)              # x_proj
                total += R * Din + Din                  # dt_proj
                total += Din * N + Din                  # A_log, D skip
                total += Din * D                        # out_proj
            elif t == "rec":
                Dr = self.rnn_width
                total += D                              # ln
                total += 2 * D * Dr                     # wx, wy
                total += Dr * self.ssm_conv + Dr        # temporal conv
                total += 2 * Dr * Dr + 2 * Dr           # input & recurrence gates
                total += Dr                             # lambda
                total += Dr * D                         # out proj
                total += D                              # ln2
                total += (3 if self.mlp_variant == "swiglu" else 2) * D * F
            else:
                raise ValueError(t)
        return total

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        if self.num_experts == 0:
            return self.param_count()
        D, F = self.d_model, self.d_ff
        n_mats = 3 if self.mlp_variant == "swiglu" else 2
        dense_equiv = self.param_count()
        dead = (self.num_experts - self.experts_per_token) * n_mats * D * F
        return dense_equiv - dead * sum(1 for t in self.layer_types if t == "moe")

    def flops_per_token(self, seq_len: int = 1) -> float:
        """~6 * N_active * 1 fwd+bwd per token (fwd only: /3). Attention
        quadratic term added for honesty at long seq."""
        n = self.active_param_count()
        fl = 2.0 * n  # forward multiply-adds
        # attention score+value flops per token at context length seq_len
        H, hd = self.num_heads, self.head_dim
        attn_layers = sum(1 for t in self.layer_types if t in ("attn", "moe"))
        ctx = seq_len if self.window == 0 else min(seq_len, self.window)
        fl += attn_layers * 4.0 * H * hd * ctx
        return fl


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One (input-shape) cell of the assignment."""

    name: str                       # train_4k | prefill_32k | decode_32k | long_500k
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k needs sub-quadratic attention (SSM / hybrid / SWA)."""
    if shape.name != "long_500k":
        return True
    sub_quadratic = (
        all(t in ("ssm", "rec") for t in set(cfg.layer_types))
        or (cfg.window > 0)
        or (set(cfg.block_pattern) <= {"rec", "attn"} and "rec" in cfg.block_pattern)
    )
    return sub_quadratic
