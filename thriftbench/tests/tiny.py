"""A tiny copy of the benchmark for tests on the CPU: the same harness and
files, one pool of small arms of each block type the cells run (GQA dense
with a GELU MLP, windowed SwiGLU dense, top-k MoE, Mamba), a backlog mix
and a Poisson mix, in a temporary checkout laid out as the real one."""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

BASE = {"family": "dense", "num_layers": 2, "d_model": 64, "num_heads": 4, "num_kv_heads": 2,
        "d_ff": 128, "vocab_size": 512, "head_dim": 0, "num_experts": 0, "experts_per_token": 0,
        "expert_capacity_factor": 1.25, "moe_ep": False, "ssm_state": 0, "ssm_conv": 4,
        "ssm_expand": 2, "ssm_dt_rank": 0, "ssm_chunk": 256, "rnn_width": 0, "window": 0,
        "local_window": 2048, "rope_theta": 10000.0, "qkv_bias": False, "mlp_variant": "swiglu",
        "attn_buckets": 0, "kv_quant": "none", "block_pattern": ["attn"], "tie_embeddings": True,
        "norm_eps": 1e-6, "frontend": "none", "frontend_len": 0, "dtype": "bfloat16",
        "remat": False, "num_microbatches": 1, "loss_chunk": 0, "logits_softcap": 0.0}

ARMS = {
    "tiny-gqa": dict(BASE, name="tiny-gqa", num_heads=6, num_kv_heads=2, d_model=96,
                     mlp_variant="gelu"),
    "tiny-window": dict(BASE, name="tiny-window", window=8, tie_embeddings=False),
    "tiny-moe": dict(BASE, name="tiny-moe", family="moe", d_ff=32, num_experts=8,
                     experts_per_token=2, block_pattern=["moe"]),
    "tiny-ssm": dict(BASE, name="tiny-ssm", family="ssm", num_heads=0, num_kv_heads=0, d_ff=0,
                     ssm_state=8, block_pattern=["ssm"], tie_embeddings=False),
}


def price(model: dict, seq_len: int) -> float:
    """The program's price of a query (``LMArm.cost``) at ``seq_len`` tokens."""
    from repro_torch.models.config import ModelConfig
    from repro_torch.serving import USD_PER_FLOP

    cfg = ModelConfig(**dict(model, block_pattern=tuple(model["block_pattern"])))
    return float(cfg.flops_per_token(seq_len) * seq_len / 3.0 * USD_PER_FLOP)


def pool(arms=("tiny-gqa", "tiny-window", "tiny-moe"), seq_len: int = 24) -> dict:
    prices = [price(ARMS[a], seq_len) for a in arms]
    return {"name": "tiny-pool", "num_classes": 4, "num_clusters": 3, "history_per_cluster": 40, "history_seed": 5,
            "accuracy_range": [0.6, 0.85], "accuracy_spread": 0.06,
            "dtype": "bfloat16", "reduced": [], "assumed": {},
            "arms": [{"arch": a, "source": "test", "price_usd": p, "model": ARMS[a]}
                     for a, p in zip(arms, prices)]}


def checkout(tmp: Path, arms=("tiny-gqa", "tiny-window", "tiny-moe"), seq_len: int = 24) -> Path:
    """A temporary checkout: ``src`` linked, ``thriftbench`` copied, and a
    tiny pool with a backlog cell ``tiny.backlog`` and a Poisson cell
    ``tiny.poisson`` added as files."""
    root = Path(tmp) / "checkout"
    root.mkdir()
    os.symlink(REPO / "src", root / "src")
    shutil.copytree(REPO / "thriftbench", root / "thriftbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    tb = root / "thriftbench"
    (tb / "configs" / "tiny-pool.json").write_text(json.dumps(pool(arms, seq_len)))
    (tb / "traffic" / "tiny-backlog.json").write_text(json.dumps(
        {"arrivals": "backlog", "seq_len": seq_len, "vocab": 512,
         "budget": {"kind": "sum_of_prices"}, "block": 16, "ahead_groups": 2}))
    (tb / "traffic" / "tiny-poisson.json").write_text(json.dumps(
        {"arrivals": "poisson", "rate_qps": 40.0, "lead_s": 0.5, "seq_len": seq_len,
         "vocab": 512, "budget": {"kind": "tiers", "n": 3}}))
    limits = {"unfinished": 0, "plan_mismatch": 0, "agg_mismatch": 0, "cost_mismatch": 0}
    # a bf16 router near a tie picks another expert than the f32 reference
    # does, which moves a tiny MoE's logits far more than a wide one's
    limits.update({f"gap.{a}": 5.0 if "moe" in a else 0.06 for a in arms})
    for cell, sched in (("tiny.backlog", {"max_batch": 16, "max_inflight": 2}),
                        ("tiny.poisson", {"max_batch": 8, "max_wait_s": 0.02, "max_inflight": 2})):
        (tb / "workloads" / f"{cell}.json").write_text(json.dumps(
            {"scheduler": sched, "warmup_rows": sched["max_batch"], "warmup_batches": [1],
             "qps_ahead": 600,
             "profile_s": 1, "check": {"rows_per_arm": 32, "calls": {"tiny-moe": 2}},
             "limits": limits}))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-pool", "source": "test",
                             "file": "thriftbench/configs/tiny-pool.json", "reduced": [],
                             "why": "test"})
    bench["workloads"] += [
        {"name": "tiny.backlog", "config": "tiny-pool", "traffic": "tiny-backlog", "chips": 1,
         "why": "test"},
        {"name": "tiny.poisson", "config": "tiny-pool", "traffic": "tiny-poisson", "chips": 1,
         "why": "test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            kind = "tiny.poisson" if any("poisson" in w for w in m["workloads"]) else "tiny.backlog"
            m["workloads"] = m["workloads"] + [kind]
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root
