"""Operations and bytes of the work the benchmark's cells need, and the
card's peaks: the yardstick of ``mfu`` and the kernel rooflines.

Counts are of what the inputs need, from shapes alone:

* a forward of one query through an arm: every projection, MLP and expert
  product at every prompt position (2 operations a multiply-add; a MoE
  token through its k experts only, and the router), attention scores and
  PV over the visible causal (and windowed) pairs only, the Mamba block's
  conv and scan, and the vocabulary head at the answer position only;
* one ``flash_attention`` launch: 4 hd operations a visible (query, key)
  pair and query head; q, k, v read once and o written once, in bf16;
* one ``mamba_scan`` launch: 7 f32 operations a (t, d, n) — dt A, its exp,
  the decay, dt x B, the update, C h and the sum — and 3 a (t, d) — dt x,
  D x and its add; x, B, C read (bf16), dt, A and D read (f32), y written
  (bf16) and the last state h written (f32), each once.

Peaks: NVIDIA H100 SXM data sheet, dense, at its 700 W limit.
"""
from __future__ import annotations

from typing import Dict

from thriftbench.weights import derived

PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12          # outside the tensor cores
PEAK_HBM_BYTES = 3.35e12
BF16, F32 = 2, 4


def visible_pairs(S: int, window: int) -> int:
    """(query, key) pairs a causal attention of S positions needs."""
    if window <= 0 or window >= S:
        return S * (S + 1) // 2
    return sum(min(i + 1, window) for i in range(S))


def forward_flops(model: Dict, S: int) -> float:
    """Operations one query of S prompt positions needs through the arm."""
    m = derived(model)
    D, F, V = m["d_model"], m["d_ff"], m["vocab_size"]
    total = 0.0
    for btype in m["layer_types"]:
        if btype in ("attn", "moe"):
            H, G, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
            total += S * 2 * D * (H + 2 * G) * hd + S * 2 * H * hd * D
            total += 4 * H * hd * visible_pairs(S, m.get("window", 0))
            mats = 3 if m["mlp_variant"] == "swiglu" else 2
            if btype == "attn":
                total += S * 2 * mats * D * F
            else:
                total += S * (2 * D * m["num_experts"]
                              + m["experts_per_token"] * 2 * mats * D * F)
        else:
            Din, N, R, K = m["d_inner"], m["ssm_state"], m["ssm_dt_rank"], m["ssm_conv"]
            total += S * (2 * D * 2 * Din + 2 * K * Din + 2 * Din * (R + 2 * N)
                          + 2 * R * Din + 7 * Din * N + 3 * Din + 2 * Din * D)
    return total + 2 * D * V


def attention_layers(model: Dict) -> int:
    return sum(t in ("attn", "moe") for t in derived(model)["layer_types"])


def ssm_layers(model: Dict) -> int:
    return sum(t == "ssm" for t in derived(model)["layer_types"])


def flash_launch(model: Dict, B: int, S: int) -> Dict[str, float]:
    m = derived(model)
    H, G, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    ops = 4.0 * B * H * hd * visible_pairs(S, m.get("window", 0))
    nbytes = float(BF16 * B * S * hd * (2 * H + 2 * G))
    return _bound(ops, nbytes, PEAK_BF16_FLOPS)


def mamba_launch(model: Dict, B: int, S: int) -> Dict[str, float]:
    m = derived(model)
    Din, N = m["d_inner"], m["ssm_state"]
    ops = float(B * S * Din * (7 * N + 3))
    nbytes = float(BF16 * B * S * (2 * Din + 2 * N) + F32 * B * S * Din
                   + F32 * (Din * N + Din) + F32 * B * Din * N)
    return _bound(ops, nbytes, PEAK_F32_FLOPS)


def _bound(ops: float, nbytes: float, peak: float) -> Dict[str, float]:
    t_ops, t_bytes = ops / peak, nbytes / PEAK_HBM_BYTES
    return {"ops": ops, "bytes": nbytes, "bound_s": max(t_ops, t_bytes),
            "term": "operations" if t_ops >= t_bytes else "bytes"}
