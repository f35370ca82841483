"""Latent attention and the sigmoid-routed MoE enter the benchmark as files:
a tiny MLA pool, built from ``tiny.py``'s helpers, is drawn by
``blocks/mla.py`` and ``blocks/mla_moe.py``, built by the harness with the
layers it lists, counted in launches and FLOPs by those files, sampled by
whole calls and served correct through the whole run on the CPU; the
flash bound takes q/k 192 against v 128; and the two readers the
Moonlight cell adds read what they should. The real pool file's arm is
the program's published configuration."""
import json
import math
import time
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from thriftbench import harness, weights
from thriftbench.metrics import arith
from thriftbench.reference.check import sample_rows
from thriftbench.spec import Cell, load_reader
from thriftbench.tests import tiny

REPO = Path(__file__).resolve().parents[2]
SEED = 2**31 + 3131
MLA = dict(tiny.BASE, name="tiny-mla-moe", family="moe", num_layers=3, d_ff=96,
           tie_embeddings=False, norm_eps=1e-5, block_pattern=["mla_moe"],
           layer_types=["mla", "mla_moe", "mla_moe"], num_experts=8, experts_per_token=2,
           kv_lora_rank=32, qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
           expert_d_ff=24, num_shared_experts=1, router_scoring="sigmoid", routed_scaling=2.446,
           first_dense_layers=1, rope_theta=50000.0)


@pytest.fixture
def mla_checkout(tmp_path, monkeypatch):
    """A tiny checkout whose pool holds a GQA arm and the tiny MLA arm, the
    latter with its ``layer_types`` listed and sampled by two whole calls."""
    monkeypatch.setitem(tiny.ARMS, "tiny-mla-moe",
                        {k: v for k, v in MLA.items() if k != "layer_types"})
    root = tiny.checkout(tmp_path, arms=("tiny-gqa", "tiny-mla-moe"))
    path = root / "thriftbench" / "configs" / "tiny-pool.json"
    pool = json.loads(path.read_text())
    pool["arms"][1]["model"]["layer_types"] = MLA["layer_types"]
    path.write_text(json.dumps(pool))
    path = root / "thriftbench" / "workloads" / "tiny.backlog.json"
    cell = json.loads(path.read_text())
    cell["check"]["calls"] = {"tiny-mla-moe": 2}
    path.write_text(json.dumps(cell))
    return root


def test_mla_layers_are_drawn_by_their_files():
    m = weights.derived(MLA)
    lay = weights.draw_arm(MLA, SEED, 0, "cpu")
    for layer, btype in zip(lay["layers"], m["layer_types"]):
        spec = weights.layer_spec(m, btype)
        assert {k: tuple(v.shape) for k, v in layer.items()} == {n: s for n, s, _, _ in spec}
    dense, moe = lay["layers"][0], lay["layers"][1]
    assert {"wkv_a", "kv_norm", "wkv_b", "wg", "wu", "wd"} <= set(dense)
    assert "router" not in dense and {"router", "router_bias", "ewg", "ewu", "ewd"} <= set(moe)
    assert tuple(moe["wd"].shape) == (MLA["num_shared_experts"] * MLA["expert_d_ff"], 64)
    # the selection bias is drawn at std 0.05; the shared experts' down
    # projection is scaled by the residual depth as every ``wd``
    big = weights.draw_layer(dict(MLA, num_experts=4096), 1, SEED, 0, "cpu")
    assert abs(big["router_bias"].float().std().item() - 0.05) < 0.005
    assert abs(moe["wd"].float().std().item() * math.sqrt(24 * 6) - 1) < 0.25
    # the routed experts' down projection also at 1 / routed_scaling
    ewd = moe["ewd"].float().std().item()
    assert abs(ewd * math.sqrt(24 * 6) * MLA["routed_scaling"] - 1) < 0.1


def test_build_takes_the_mla_arm_with_its_layers(mla_checkout):
    cell = Cell(mla_checkout, "tiny.backlog")
    prog = harness.build(cell, SEED, torch.device("cpu"), False, lambda m: None)
    lm = prog["arms"][1].model
    assert list(lm.cfg.layer_types) == MLA["layer_types"]
    assert [b.btype for b in lm.layers] == MLA["layer_types"]


def test_launches_and_flops_are_the_files():
    m = weights.derived(MLA)
    assert arith.launches(MLA) == {"flash_attention": 3}
    files = {t: weights.load_block(t) for t in ("mla", "mla_moe")}
    for S in (1, 7, 127):
        want = files["mla"].flops(m, S) + 2 * files["mla_moe"].flops(m, S) + 2 * 64 * 512
        assert arith.forward_flops(MLA, S) == want
    D, H, r, dn, dr, dv, S = 64, 4, 32, 16, 8, 16, 7
    attn = (S * 2 * (D * H * (dn + dr) + D * (r + dr) + r * H * (dn + dv) + H * dv * D)
            + 2 * H * (dn + dr + dv) * S * (S + 1) // 2)
    assert files["mla"].flops(m, S) == attn + S * 2 * 3 * D * 96
    assert files["mla_moe"].flops(m, S) == attn + S * (2 * D * 8 + 2 * 3 * D * (2 * 24 + 24))


@pytest.mark.parametrize("calls,refused", [({}, True), ({"tiny-mla-moe": 2}, False)])
def test_the_mla_arm_is_sampled_by_whole_calls(calls, refused):
    assert weights.load_block("mla_moe").BATCH_COUPLED
    assert not weights.load_block("mla").BATCH_COUPLED
    cell = types.SimpleNamespace(cell={"check": {"rows_per_arm": 8, "calls": calls}},
                                 config={"arms": [{"arch": "tiny-mla-moe", "model": MLA}]})
    rng = np.random.default_rng(2)
    served = {"calls": [(0, rng.integers(0, 512, (n, 24)), rng.integers(0, 4, n))
                        for n in (16, 16, 9)]}
    if refused:
        with pytest.raises(ValueError, match=r"\['mla_moe'\] layers"):
            sample_rows(cell, served, SEED)
    else:
        picks = sample_rows(cell, served, SEED)[0]
        assert len(picks) == 2
        assert [len(r) for _, r in picks] == [served["calls"][i][1].shape[0] for i, _ in picks]


def test_flash_bound_takes_moonlights_head_dims():
    pool = json.loads((REPO / "thriftbench" / "configs" / "moonlight-pool.json").read_text())
    m = weights.derived(pool["arms"][0]["model"])
    kern = arith.load_kernel("flash_attention")
    B, S = 128, 127
    pairs = S * (S + 1) // 2
    for btype in ("mla", "mla_moe"):
        got = kern.bound(m, btype, B, S)
        assert got["ops"] == 2 * B * 16 * (192 + 128) * pairs
        assert got["bytes"] == 2 * B * S * (16 + 16) * (192 + 128)


def test_the_pool_files_arm_is_the_published_configuration():
    from repro_torch.configs import get_config
    from repro_torch.models.config import ModelConfig
    from repro_torch.serving import USD_PER_FLOP

    pool = json.loads((REPO / "thriftbench" / "configs" / "moonlight-pool.json").read_text())
    arm = pool["arms"][0]
    model = {k: v for k, v in arm["model"].items() if k not in harness.OWN_KEYS}
    cfg = ModelConfig(**dict(model, block_pattern=tuple(model["block_pattern"])))
    assert cfg == get_config("moonlight-16b-a3b")
    assert list(cfg.layer_types) == arm["model"]["layer_types"] == ["mla"] + ["mla_moe"] * 26
    assert arm["params"] == cfg.param_count() == 15_960_110_208
    assert arm["price_usd"] == cfg.flops_per_token(128) * 128 / 3.0 * USD_PER_FLOP
    assert arm["price_usd"] == max(a["price_usd"] for a in pool["arms"])
    published = {"hidden_size": "d_model", "intermediate_size": "d_ff",
                 "moe_intermediate_size": "expert_d_ff", "n_routed_experts": "num_experts",
                 "num_experts_per_tok": "experts_per_token", "n_shared_experts": "num_shared_experts",
                 "first_k_dense_replace": "first_dense_layers", "kv_lora_rank": "kv_lora_rank",
                 "qk_nope_head_dim": "qk_nope_head_dim", "qk_rope_head_dim": "qk_rope_head_dim",
                 "v_head_dim": "v_head_dim", "num_attention_heads": "num_heads",
                 "num_key_value_heads": "num_kv_heads", "num_hidden_layers": "num_layers",
                 "vocab_size": "vocab_size", "rope_theta": "rope_theta", "rms_norm_eps": "norm_eps",
                 "routed_scaling_factor": "routed_scaling"}
    for key, ours in published.items():          # the published config.json beside the arm
        assert pool[key] == arm["model"][ours], key
    # the port's sigmoid scoring is noaux_tc with the chosen scores normalised
    assert pool["scoring_func"] == cfg.router_scoring and pool["topk_method"] == "noaux_tc"
    assert pool["norm_topk_prob"] is True
    assert pool["q_lora_rank"] is None and pool["tie_word_embeddings"] is cfg.tie_embeddings
    assert pool["n_group"] == pool["topk_group"] == 1
    gqa = json.loads((REPO / "thriftbench" / "configs" / "gqa-pool.json").read_text())
    assert pool["arms"][1:] == gqa["arms"][1:] and pool["reduced"] == []


def test_a_cpu_run_of_the_mla_pool_is_correct(mla_checkout):
    torch.set_num_threads(1)
    res = harness.run(mla_checkout, "tiny.backlog", SEED, 0.5, False, "cpu", time.monotonic(),
                      lambda m: None)
    assert res["correct"], res["checks"]
    assert "gap.tiny-mla-moe" in res["checks"] and res["attempted"] > 0


def _ctx(idle_gaps, window_s=5.0):
    return {"slice": {"idle_gaps": idle_gaps, "window_s": window_s}}


def test_idle_share_of_the_layers_reads_the_layer_marks_only():
    read = load_reader(REPO / "thriftbench" / "metrics" / "device.idle_share.layers.py")
    gaps = [["arm.moe.dispatch", 0.4], ["host", 0.3], ["arm.mla.project", 0.1],
            ["arm.granite-moe-1b-a400m.launch", 0.2], ["arm.moe.route", 0.05]]
    assert read(_ctx(gaps)) == pytest.approx(0.55 / 5.0)
    assert read(_ctx([["host", 1.0]])) == 0.0
    assert read({"slice": None}) is None


def test_dropped_share_reads_the_programs_pair_counter(monkeypatch):
    from repro_torch import trace
    from repro_torch.models import moe

    read = load_reader(REPO / "thriftbench" / "metrics" / "moe.dropped_share.py")
    moe.PAIRS.reset()
    ctx = _ctx([])
    assert read(ctx) is None                        # nothing routed
    x = torch.randn(40, 16, generator=torch.Generator().manual_seed(1)).abs()
    router = torch.arange(4.0).expand(16, 4)       # every token's logits rise with the expert
    w = torch.randn(4, 16, 8, generator=torch.Generator().manual_seed(2))
    wd = torch.randn(4, 8, 16, generator=torch.Generator().manual_seed(3))
    moe.moe_mlp(x, router, w, w, wd, 2, 1.0)        # outside a recording: not counted
    assert moe.PAIRS.routed() == 0
    monkeypatch.setattr(trace, "_profiling", lambda: True)
    moe.moe_mlp(x, router, w, w, wd, 2, 1.0)
    # every token routes to experts 3 and 2, 40 pairs each against a capacity
    # of ceil(40 * 2 / 4) = 20 rounded up to 24: 16 dropped at each
    assert moe.PAIRS.routed() == 80 and moe.PAIRS.dropped() == 32
    assert read(ctx) == pytest.approx(0.4)
    # a second MoE shape is counted apart, and the reader sums the shapes
    w8 = torch.randn(8, 16, 8, generator=torch.Generator().manual_seed(4))
    wd8 = torch.randn(8, 8, 16, generator=torch.Generator().manual_seed(5))
    moe.moe_mlp(x, torch.zeros(16, 8), w8, w8, wd8, 2, 1.0)   # ties: experts 0 and 1
    assert moe.PAIRS.keys() == [(4, 2), (8, 2)]
    assert moe.PAIRS.routed((8, 2)) == 80 and moe.PAIRS.dropped((8, 2)) == 2 * (40 - 16)
    assert read(ctx) == pytest.approx((32 + 48) / 160)
    assert read({"slice": None}) is None


def test_a_recording_starts_the_pair_counter_from_zero():
    """A second traced slice in one process reads its own pairs only: the
    profiler's start resets the counter."""
    from repro_torch.models import moe

    moe.PAIRS.reset()
    x = torch.randn(40, 16, generator=torch.Generator().manual_seed(1))
    w = torch.randn(4, 16, 8, generator=torch.Generator().manual_seed(2))
    wd = torch.randn(4, 8, 16, generator=torch.Generator().manual_seed(3))
    for _ in range(2):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
            moe.moe_mlp(x, torch.randn(16, 4, generator=torch.Generator().manual_seed(4)),
                        w, w, wd, 2, 1.25)
        assert moe.PAIRS.routed() == 80
