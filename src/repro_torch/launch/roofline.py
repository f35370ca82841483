"""Roofline accounting (the port of ``repro/launch/roofline.py``).

**Analytic implementation counting** (``analytic_flops`` /
``analytic_bytes`` / ``analytic_memory``): the JAX package's counts,
ported verbatim in the same arithmetic order, so every number equals the
JAX package's for the same config and shape. ``roofline_terms`` reads the
card's constants (:data:`repro_torch.launch.mesh.HW`: an H100's in place
of a TPU v5e's).

**Counted FLOPs** (:func:`flop_count`): the counterpart of
``xla_cost_analysis``, through ``torch.utils.flop_counter.FlopCounterMode``;
it runs on meta tensors, and like XLA's count it counts matmuls and
convolutions (every layer here: the port has no scan whose body XLA
counts once).

What differs on the card: ``analytic_flops`` counts the *blocked*
attention of the JAX package — every masked KV block, ``T = S`` for a
causal prefill or training step (``_attn_flops``), as the port's plain
blocked attention also does (it is what ``flop_count`` sees on meta). The
port's CUDA ``flash_attention`` (``csrc/flash_attention.cu``: ``k_hi =
causal ? min(Tk, q_last + 1) : Tk``) walks only the visible KV tiles, so
on the card the score and probability-times-value terms of a causal
prefill or training step are about half this count. The JAX count is
kept, so the two packages agree.

No counterpart: ``parse_hlo``, ``hlo_collective_bytes``, ``_shape_bytes``
and ``_Instr`` read XLA's HLO text, and the port has no compiler output
that names its collectives.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

from repro_torch.models import ModelConfig, ShapeConfig
from repro_torch.models.init import padded_vocab
from repro_torch.models.model import block_window


def flop_count(fn: Callable, *args, **kwargs) -> float:
    """FLOPs of ``fn(*args, **kwargs)`` as ``FlopCounterMode`` counts them
    (matmuls and convolutions), on whatever device the arguments are;
    on ``meta`` nothing is computed."""
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as counter:
        fn(*args, **kwargs)
    return float(counter.get_total_flops())


# ---------------------------------------------------------------------------
# Analytic implementation FLOPs / bytes
# ---------------------------------------------------------------------------


def _attn_flops(cfg: ModelConfig, Bt: float, S: float, T: float, blocked: bool) -> float:
    """Forward attention flops for Bt sequences of S queries against T keys.

    The blocked baseline visits every (padded) KV block and masks, so its
    score/value flops use the full T (the deliberate ~2x causal waste)."""
    H, G, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    D = cfg.d_model
    fl = 2 * Bt * S * D * (H + 2 * G) * hd          # qkv projections
    fl += 6 * Bt * S * (H + G) * hd                 # rope
    fl += 2 * Bt * S * T * H * hd                   # scores
    fl += 5 * Bt * S * T * H                        # softmax-ish
    fl += 2 * Bt * S * T * H * hd                   # prob @ v
    fl += 2 * Bt * S * H * hd * D                   # out proj
    return fl


def _mlp_flops(cfg: ModelConfig, tokens: float) -> float:
    n_mats = 3 if cfg.mlp_variant == "swiglu" else 2
    return 2 * n_mats * tokens * cfg.d_model * cfg.d_ff + 4 * tokens * cfg.d_ff


def _moe_flops(cfg: ModelConfig, tokens: float) -> float:
    E, k = cfg.num_experts, cfg.experts_per_token
    C = max(8.0, math.ceil(tokens * k / E * cfg.expert_capacity_factor / 8) * 8)
    n_mats = 3 if cfg.mlp_variant == "swiglu" else 2
    fl = 2 * tokens * cfg.d_model * E               # router
    fl += 2 * n_mats * (E * C) * cfg.d_model * cfg.d_ff
    fl += 2 * tokens * k * cfg.d_model              # combine
    return fl


def _ssm_flops(cfg: ModelConfig, tokens: float) -> float:
    D, Din, N, R = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_dt_rank
    fl = 2 * tokens * D * 2 * Din                   # in_proj
    fl += 2 * cfg.ssm_conv * tokens * Din           # conv
    fl += 2 * tokens * Din * (R + 2 * N)            # x_proj
    fl += 2 * tokens * R * Din                      # dt_proj
    fl += 8 * tokens * Din * N                      # recurrence + contraction
    fl += 6 * tokens * Din                          # gates
    fl += 2 * tokens * Din * D                      # out_proj
    return fl


def _rec_flops(cfg: ModelConfig, tokens: float) -> float:
    D, Dr = cfg.d_model, cfg.rnn_width
    fl = 2 * tokens * D * 2 * Dr                    # wy, wx
    fl += 2 * cfg.ssm_conv * tokens * Dr            # conv
    fl += 2 * 2 * tokens * Dr * Dr                  # gates
    fl += 12 * tokens * Dr                          # rg-lru scan
    fl += 2 * tokens * Dr * D                       # out proj
    return fl + _mlp_flops(cfg, tokens)


def analytic_flops(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, float]:
    """Global forward / total FLOPs of this implementation for one step."""
    cfg.refuse_mla("the roofline accounting")
    Bt = float(shape.global_batch)
    win = block_window(cfg)
    if shape.kind in ("train", "prefill"):
        S = float(shape.seq_len)
        # baseline blocked attention visits all (masked) KV blocks; the
        # prefix-bucketed causal scan (perf iteration #1) visits a
        # (G+1)/(2G) fraction
        if cfg.attn_buckets > 0:
            G = cfg.attn_buckets
            T = S * (G + 1) / (2.0 * G)
        else:
            T = S
        decode = False
    else:
        S = 1.0
        T = float(min(win, shape.seq_len) if win else shape.seq_len)
        decode = True
    tokens = Bt * S

    fwd = 0.0
    for t in cfg.layer_types:
        if t == "attn":
            fwd += _attn_flops(cfg, Bt, S, T, not decode) + _mlp_flops(cfg, tokens)
        elif t == "moe":
            fwd += _attn_flops(cfg, Bt, S, T, not decode) + _moe_flops(cfg, tokens)
        elif t == "ssm":
            fwd += _ssm_flops(cfg, tokens)
        elif t == "rec":
            fwd += _rec_flops(cfg, tokens)
    V = padded_vocab(cfg)
    if shape.kind == "train":
        fwd += 2 * tokens * cfg.d_model * V + 4 * tokens * V       # logits+loss
    else:
        fwd += 2 * Bt * cfg.d_model * V                            # last-position logits

    if shape.kind == "train":
        total = (4.0 if cfg.remat else 3.0) * fwd
    else:
        total = fwd
    return {"fwd": fwd, "total": total}


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Idealized MODEL_FLOPS: 6·N_active·tokens (train) / 2·N_active·tokens."""
    n = cfg.active_param_count()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n * tokens


def analytic_bytes(cfg: ModelConfig, shape: ShapeConfig) -> Dict[str, float]:
    """Global HBM traffic estimate (bytes) for one step of this impl."""
    cfg.refuse_mla("the roofline accounting")
    n_params = cfg.param_count()
    p_bytes = 2.0 if cfg.dtype == "bfloat16" else 4.0
    Bt = float(shape.global_batch)
    D = cfg.d_model

    if shape.kind == "train":
        micro = max(cfg.num_microbatches, 1)
        passes = (3.0 if cfg.remat else 2.0)  # fwd (+recompute) + bwd
        traffic = n_params * p_bytes * (passes * micro + 1)      # reads + grad write
        traffic += n_params * 4.0 * 5                            # adam m,v,master r/w
        act = Bt * shape.seq_len * D * p_bytes
        traffic += act * len(cfg.layer_types) * 4                # per-layer act r/w
        return {"total": traffic}
    if shape.kind == "prefill":
        act = Bt * shape.seq_len * D * p_bytes
        return {"total": n_params * p_bytes + act * len(cfg.layer_types) * 4}
    # decode: params + full cache traffic dominate
    cache = _cache_bytes(cfg, shape, p_bytes)
    return {"total": n_params * p_bytes + cache, "cache": cache}


def analytic_memory(
    cfg: ModelConfig, shape: ShapeConfig, dp: int, tp: int
) -> Dict[str, float]:
    """Per-chip HBM residency model (bytes) under the baseline sharding:
    params/optimizer sharded over dp*tp (FSDP x TP), batch over dp,
    activations per microbatch, KV cache over dp (+ tp when heads divide).

    This is the fits-in-HBM criterion for the dry-run; XLA's CPU-backend
    memory_analysis is used only as a cross-check on argument sizes (its
    peak/temp fields are not meaningful for the partitioned module on CPU).
    """
    chips = dp * tp
    p_bytes = 2.0 if cfg.dtype == "bfloat16" else 4.0
    n = cfg.param_count()
    out: Dict[str, float] = {}
    out["params"] = n * p_bytes / chips

    if shape.kind == "train":
        out["opt_state"] = n * 12.0 / chips        # m, v, master fp32
        out["grads"] = n * 4.0 / chips             # fp32 accumulators
        micro = max(cfg.num_microbatches, 1)
        b_local = shape.global_batch / dp / micro
        carry = b_local * shape.seq_len * cfg.d_model * p_bytes
        out["act_carries"] = carry * cfg.num_layers
        # transient working set: widest per-layer intermediate (attention
        # block scores or mlp hidden), a few copies
        widest = max(
            b_local * shape.seq_len * max(cfg.d_ff, cfg.d_model * 2, 1) * p_bytes / tp,
            b_local * shape.seq_len * 512 * max(cfg.num_heads, 1) * 4.0 / tp,
        )
        V = padded_vocab(cfg)
        s_eff = min(cfg.loss_chunk, shape.seq_len) if cfg.loss_chunk else shape.seq_len
        logits = b_local * s_eff * V * 4.0 / tp
        out["transients"] = 3 * widest + logits
    elif shape.kind == "prefill":
        b_local = shape.global_batch / dp
        out["acts"] = 4 * b_local * shape.seq_len * cfg.d_model * p_bytes
        # output cache carries the decode sharding: batch over dp, time over tp
        out["cache_out"] = _cache_bytes(cfg, shape, p_bytes) / (dp * tp)
    else:
        # cache sharded over batch (dp, capped by B) and time/state (tp)
        shards = max(min(dp, shape.global_batch), 1) * tp
        out["cache"] = _cache_bytes(cfg, shape, p_bytes) / shards
        out["transients"] = out["params"] * 0.05
    out["total"] = sum(out.values())
    return out


def _cache_bytes(cfg: ModelConfig, shape: ShapeConfig, p_bytes: float) -> float:
    cfg.refuse_mla("the roofline accounting")
    win = block_window(cfg)
    T = float(min(win, shape.seq_len) if win else shape.seq_len)
    B = float(shape.global_batch)
    # int8 KV (perf iteration #3): 1 byte/elem + one fp32 scale per (t, head)
    kv_bytes = 1.0 + 4.0 / max(cfg.head_dim, 1) if cfg.kv_quant == "int8" else p_bytes
    total = 0.0
    for t in cfg.layer_types:
        if t in ("attn", "moe"):
            total += B * T * cfg.num_kv_heads * cfg.head_dim * 2 * kv_bytes
        elif t == "ssm":
            total += B * cfg.d_inner * cfg.ssm_state * 4.0
            total += B * (cfg.ssm_conv - 1) * cfg.d_inner * p_bytes
        elif t == "rec":
            total += B * cfg.rnn_width * 4.0
            total += B * (cfg.ssm_conv - 1) * cfg.rnn_width * p_bytes
    return total


# ---------------------------------------------------------------------------
# Roofline terms
# ---------------------------------------------------------------------------


# Wire bytes pushed through EACH chip's links per byte of (per-device) HLO
# operand, by collective kind: ring all-reduce moves ~2x the operand (reduce-
# scatter phase + all-gather phase); all-gather moves ~the output (~operand
# here since we record operand bytes of the gather's input times the group,
# conservatively 1x); the rest ~1x.
WIRE_FACTOR = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}


def wire_bytes_per_chip(coll: Dict[str, float]) -> float:
    """Per-chip wire traffic from the parsed per-device operand byte sums.

    The SPMD module's operand shapes are per-device shards (or full global
    tensors when GSPMD involuntarily replicates — exactly the pathology this
    accounting surfaces), and each chip pushes ~WIRE_FACTOR x operand bytes
    through its own links, independent of chip count.
    """
    return sum(WIRE_FACTOR.get(k, 1.0) * v for k, v in coll.items() if k in WIRE_FACTOR)


def roofline_terms(
    flops: float,
    hbm_bytes: float,
    collective_bytes: float,
    chips: int,
    hw: Dict[str, float],
    wire_per_chip: Optional[float] = None,
) -> Dict[str, float]:
    """The three roofline terms in seconds.

    ``collective_bytes`` follows the assignment's convention (global bytes,
    divided by aggregate chips x link bandwidth); when ``wire_per_chip`` is
    supplied (per-chip wire traffic from :func:`wire_bytes_per_chip`) the
    collective term is wire_per_chip / link_bw — the physically meaningful
    form, equal to the assignment's formula with
    collective_bytes = wire_per_chip * chips.
    """
    compute_s = flops / (chips * hw["peak_flops"])
    memory_s = hbm_bytes / (chips * hw["hbm_bw"])
    if wire_per_chip is not None:
        collective_s = wire_per_chip / hw["ici_bw"]
    else:
        collective_s = collective_bytes / (chips * hw["ici_bw"])
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": collective_s}
    dom = max(terms, key=terms.get)
    terms["bottleneck"] = dom
    terms["step_s_lower_bound"] = max(compute_s, memory_s, collective_s)
    return terms
