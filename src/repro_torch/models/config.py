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
  ``mla``    latent attention (DeepSeek-V2/V3 MLA: queries at full rank, keys
             and values from one normed ``kv_lora_rank`` latent, a RoPE part
             shared by every head) + SwiGLU
  ``mla_moe`` the same attention, then a top-k MoE FFN beside shared experts

The port's own fields past the JAX package's (latent attention, the
sigmoid router with its selection bias, shared experts, leading dense
layers) default to what leaves a configuration as the JAX package builds
it. ``first_dense_layers`` leading layers take the dense counterpart of
the pattern's type (``moe`` -> ``attn``, ``mla_moe`` -> ``mla``), as
DeepSeek-V3's ``first_k_dense_replace``; the pattern cycles over the rest.
"""
from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple


MLA_TYPES = frozenset(("mla", "mla_moe"))
DENSE_OF = {"moe": "attn", "mla_moe": "mla"}   # a MoE type's dense counterpart


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
    # --- latent attention (mla / mla_moe blocks) ---
    kv_lora_rank: int = 0           # the latent's width; 0 = no latent attention
    qk_nope_head_dim: int = 0       # per-head q/k columns without RoPE
    qk_rope_head_dim: int = 0       # q/k columns with RoPE; k's are shared by the heads
    v_head_dim: int = 0
    # --- MoE details ---
    expert_d_ff: int = 0            # mla_moe: routed experts' width; 0 = d_ff
    num_shared_experts: int = 0     # shared experts of width expert_d_ff, as one SwiGLU
    # softmax (over the k chosen logits) | sigmoid (DeepSeek-V3's noaux_tc: a
    # per-expert bias added to choose, not to weigh; the k chosen scores
    # normalised to sum 1, then times routed_scaling)
    router_scoring: str = "softmax"
    routed_scaling: float = 1.0     # sigmoid: the routed output's factor
    first_dense_layers: int = 0     # leading layers of the pattern type's dense counterpart

    def __post_init__(self):
        if self.head_dim == 0 and self.num_heads > 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.ssm_dt_rank == 0 and self.ssm_state > 0:
            object.__setattr__(self, "ssm_dt_rank", math.ceil(self.d_model / 16))
        if self.rnn_width == 0 and "rec" in self.block_pattern:
            object.__setattr__(self, "rnn_width", self.d_model)
        self._check_port_fields()

    def _check_port_fields(self) -> None:
        """Refuse what the port's own fields cannot build."""
        mla = bool(set(self.block_pattern) & MLA_TYPES)
        if mla and not (self.kv_lora_rank > 0 and self.qk_nope_head_dim > 0
                        and self.qk_rope_head_dim > 0 and self.v_head_dim > 0):
            raise ValueError(f"{self.name}: mla blocks need kv_lora_rank, qk_nope_head_dim, "
                             "qk_rope_head_dim and v_head_dim")
        if self.kv_lora_rank and not mla:
            raise ValueError(f"{self.name}: kv_lora_rank is for mla blocks; the pattern is "
                             f"{self.block_pattern}")
        if mla and self.kv_quant != "none":
            raise ValueError(f"{self.name}: the mla blocks' latent cache is not quantized "
                             f"(kv_quant {self.kv_quant!r})")
        if self.v_head_dim > self.qk_nope_head_dim + self.qk_rope_head_dim:
            raise ValueError(f"{self.name}: v_head_dim {self.v_head_dim} above the q/k head dim")
        if self.router_scoring not in ("softmax", "sigmoid"):
            raise ValueError(f"{self.name}: router_scoring {self.router_scoring!r}")
        if self.first_dense_layers:
            if not 0 < self.first_dense_layers <= self.num_layers:
                raise ValueError(f"{self.name}: first_dense_layers {self.first_dense_layers} "
                                 f"of {self.num_layers} layers")
            if len(set(self.block_pattern)) != 1 or self.block_pattern[0] not in DENSE_OF:
                raise ValueError(f"{self.name}: first_dense_layers takes a pattern of one MoE "
                                 f"type ({sorted(DENSE_OF)}), not {self.block_pattern}")
        if self.expert_d_ff and "moe" in self.block_pattern:
            raise ValueError(f"{self.name}: moe blocks' experts take d_ff; expert_d_ff is for "
                             "mla_moe blocks")
        if self.moe_ep and "mla_moe" in self.block_pattern:
            raise ValueError(f"{self.name}: expert parallelism (moe_ep) does not take mla_moe "
                             "blocks")

    def refuse_mla(self, what: str) -> None:
        """Raise a ``ValueError`` naming the latent-attention block types of
        this configuration, for a path (``what``) that cannot take them."""
        types = sorted(set(self.layer_types) & MLA_TYPES)
        if types:
            raise ValueError(f"{what} does not take the block types {types} ({self.name})")

    # ------------------------------------------------------------------
    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def expert_width(self) -> int:
        """The routed (and each shared) expert's width."""
        return self.expert_d_ff or self.d_ff

    @property
    def layer_types(self) -> List[str]:
        pat, k = self.block_pattern, self.first_dense_layers
        dense = [DENSE_OF[pat[0]]] * k if k else []
        return dense + [pat[i % len(pat)] for i in range(self.num_layers - k)]

    def segments(self) -> List[Tuple[Tuple[str, ...], int]]:
        """Split layers into (pattern_unit, n_repeats) scan segments.

        ``num_layers = 38`` with pattern (rec, rec, attn) becomes
        ``[(('rec','rec','attn'), 12), (('rec','rec'), 1)]``; leading dense
        layers are a segment of their own before them (27 layers, pattern
        (mla_moe,), one dense: ``[(('mla',), 1), (('mla_moe',), 26)]``).
        """
        unit = self.block_pattern
        u = len(unit)
        k = self.first_dense_layers
        full, rem = divmod(self.num_layers - k, u)
        segs: List[Tuple[Tuple[str, ...], int]] = []
        if k:
            segs.append(((DENSE_OF[unit[0]],), k))
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
            elif t in MLA_TYPES:
                total += 2 * D + self.mla_attention_params()  # ln1, ln2, attention
                if t == "mla":
                    total += 3 * D * F
                else:
                    total += self.moe_ffn_params()
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

    def mla_attention_params(self) -> int:
        """One latent attention's weights: q, the latent's down projection
        (with k's RoPE part), its norm, its up projection to k_nope and v,
        and the output."""
        D, H, r = self.d_model, self.num_heads, self.kv_lora_rank
        dn, dr, dv = self.qk_nope_head_dim, self.qk_rope_head_dim, self.v_head_dim
        return D * H * (dn + dr) + D * (r + dr) + r + r * H * (dn + dv) + H * dv * D

    def moe_ffn_params(self) -> int:
        """An mla_moe layer's FFN: routed and shared SwiGLU experts, the
        router and its selection bias."""
        D, E, Fe = self.d_model, self.num_experts, self.expert_width
        bias = E if self.router_scoring == "sigmoid" else 0
        return E * 3 * D * Fe + 3 * D * Fe * self.num_shared_experts + D * E + bias

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top-k experts)."""
        if self.num_experts == 0:
            return self.param_count()
        D, F = self.d_model, self.d_ff
        n_mats = 3 if self.mlp_variant == "swiglu" else 2
        dense_equiv = self.param_count()
        dead = (self.num_experts - self.experts_per_token) * n_mats * D * F
        dead_mla = (self.num_experts - self.experts_per_token) * 3 * D * self.expert_width
        return (dense_equiv - dead * sum(1 for t in self.layer_types if t == "moe")
                - dead_mla * sum(1 for t in self.layer_types if t == "mla_moe"))

    def flops_per_token(self, seq_len: int = 1) -> float:
        """~6 * N_active * 1 fwd+bwd per token (fwd only: /3). Attention
        quadratic term added for honesty at long seq: 4 H hd a context
        position, and 2 H (q/k dim + v dim) in a latent attention layer."""
        n = self.active_param_count()
        fl = 2.0 * n  # forward multiply-adds
        # attention score+value flops per token at context length seq_len
        H, hd = self.num_heads, self.head_dim
        attn_layers = sum(1 for t in self.layer_types if t in ("attn", "moe"))
        ctx = seq_len if self.window == 0 else min(seq_len, self.window)
        fl += attn_layers * 4.0 * H * hd * ctx
        mla_layers = sum(1 for t in self.layer_types if t in MLA_TYPES)
        if mla_layers:
            dims = self.qk_nope_head_dim + self.qk_rope_head_dim + self.v_head_dim
            fl += mla_layers * 2.0 * H * dims * ctx
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
