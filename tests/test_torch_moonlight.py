"""Moonlight-16B-A3B as published, on the port's own path: the latent
attention (``mla``) and the sigmoid-routed MoE with shared experts
(``mla_moe``) held to the benchmark's plain reference
(``thriftbench/blocks/mla.py``, ``mla_moe.py``) on the CPU, block by block,
whole and through prefill and decode; the router's bias, normalisation and
scaling; the published sizes and price; the paths that do not take these
blocks raising; and ``flash_attention`` with a v narrower than q/k.

Tolerances: the program and the reference both compute in f32 on the CPU,
in different orders (fused projections against split ones, a cat against
slices, einsum against bmm), so they agree to f32 rounding carried through
a few layers: 1e-5 of the outputs' scale."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import ops, ref
from repro_torch.models import LM, attention, blocks, moe
from repro_torch.models.config import ModelConfig
from thriftbench import weights
from thriftbench.reference.model import answer_logits

ARCH = "moonlight-16b-a3b"
SEED = 2**31 + 4242
TOL = 1e-5


def model_dict(cfg: ModelConfig) -> dict:
    """A pool file's arm model of ``cfg``: its fields and layer types."""
    m = dataclasses.asdict(cfg)
    return dict(m, block_pattern=list(m["block_pattern"]), layer_types=list(cfg.layer_types))


@pytest.fixture(scope="module")
def smoke():
    torch.manual_seed(0)
    cfg = configs.get_smoke_config(ARCH)
    model = model_dict(cfg)
    return cfg, model, weights.draw_arm(model, SEED, 0, "cpu")


def close(got, want, tol=TOL):
    scale = want.abs().max().item()
    assert (got.float() - want.float()).abs().max().item() <= tol * max(scale, 1.0)


@pytest.mark.parametrize("i", [0, 1, 2])
def test_each_block_equals_the_reference_file(smoke, i):
    cfg, model, lay = smoke
    btype = cfg.layer_types[i]
    h = torch.randn(3, 12, cfg.d_model, generator=torch.Generator().manual_seed(i))
    p = lay["layers"][i]
    want = weights.load_block(btype).forward(h, p, weights.derived(model), "f32", [3])
    with torch.no_grad():
        got = (blocks.mla_block(p, h, cfg, window=0) if btype == "mla"
               else blocks.mla_moe_block(p, h, cfg, window=0)[0])
    close(got, want)


def test_the_model_equals_the_reference_at_the_last_position(smoke):
    cfg, model, lay = smoke
    lm = LM(cfg, device="cpu", params=lay)
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, 512, (4, 15)))
    with torch.no_grad():
        got = lm(tokens)[:, -1, :cfg.vocab_size]
    want = answer_logits(model, tokens, SEED, 0)
    close(got, want)
    # two served batches: each segment's tokens make its own capacity
    with torch.no_grad():
        two = torch.cat([lm(tokens[:1])[:, -1], lm(tokens[1:])[:, -1]])[:, :cfg.vocab_size]
    close(two, answer_logits(model, tokens, SEED, 0, segments=[1, 3]))


def test_prefill_then_decode_through_the_latent_cache(smoke):
    """12 positions prefilled, then 4 decode steps, each against the whole
    forward at its position. A decode step routes its B tokens together and
    a forward all B S, so the capacity factor is raised until nothing is
    dropped in either: then both compute the same function."""
    cfg, _, lay = smoke
    cfg = dataclasses.replace(cfg, expert_capacity_factor=16.0)
    lm = LM(cfg, device="cpu", params=lay)
    tokens = torch.as_tensor(np.random.default_rng(2).integers(0, 512, (3, 16)))
    with torch.no_grad():
        full = lm(tokens)
    logits, cache = lm.prefill(tokens[:, :12], extra_slots=4)
    close(logits, full[:, 11])
    for layer, btype in zip(cache["layers"], cfg.layer_types):
        assert set(layer) == {"c_kv", "k_pe"}
        assert layer["c_kv"].shape == (3, 16, cfg.kv_lora_rank)
        assert layer["k_pe"].shape == (3, 16, cfg.qk_rope_head_dim)
    for t in range(12, 16):
        logits, cache = lm.decode_step(cache, tokens[:, t:t + 1])
        close(logits, full[:, t])
    assert cache["pos"] == 16


def test_the_published_latent_cache_is_576_values_a_position():
    lm = LM(configs.get_config(ARCH), device="meta")
    cache = lm.init_cache(2, 8)
    assert len(cache["layers"]) == 27
    for layer in cache["layers"]:
        assert sum(t.shape[-1] for t in layer.values()) == 576
        assert all(t.shape[:2] == (2, 8) for t in layer.values())


def test_the_bias_chooses_the_experts_and_the_scores_weigh_them():
    logits = torch.tensor([[2.0, 1.0, 0.0, -1.0]])
    bias = torch.tensor([0.0, 0.0, 0.5, 0.9])
    idx, w = moe.router_sigmoid_topk(logits, 2, bias, scaling=1.0)
    assert idx.tolist() == [[3, 2]]                # sigmoid + bias: .88, .73, 1.0, 1.17
    s = torch.sigmoid(logits)[:, [3, 2]]           # .27 and .5, no bias
    torch.testing.assert_close(w, s / (s.sum() + 1e-20), rtol=0, atol=0)
    idx0, _ = moe.router_sigmoid_topk(logits, 2, torch.zeros(4), scaling=1.0)
    assert idx0.tolist() == [[0, 1]]               # without the bias, the two largest scores


def test_routed_scaling_and_normalisation():
    logits = torch.randn(64, 8, generator=torch.Generator().manual_seed(3))
    bias = torch.randn(8, generator=torch.Generator().manual_seed(4)) * 0.05
    idx, w = moe.router_sigmoid_topk(logits, 3, bias, scaling=2.446)
    torch.testing.assert_close(w.sum(dim=1), torch.full((64,), 2.446), rtol=1e-6, atol=0)
    s = torch.sigmoid(logits).gather(1, idx)
    torch.testing.assert_close(w, s / (s.sum(dim=1, keepdim=True) + 1e-20) * 2.446)
    idx1, w1 = moe.router_sigmoid_topk(logits, 3, bias, scaling=1.0)
    assert torch.equal(idx1, idx)
    torch.testing.assert_close(w1 * 2.446, w)


def test_the_softmax_router_is_unchanged():
    """The softmax path's call, without the sigmoid router's keywords, is the
    one granite serves: its output equals the router's own softmax route."""
    g = torch.Generator().manual_seed(5)
    x, router = torch.randn(40, 16, generator=g), torch.randn(16, 8, generator=g)
    w, wd = torch.randn(8, 16, 12, generator=g), torch.randn(8, 12, 16, generator=g)
    out, aux = moe.moe_mlp(x, router, w, w, wd, 2, 1.25)
    again, aux2 = moe.moe_mlp(x, router, w, w, wd, 2, 1.25, scoring="softmax")
    assert torch.equal(out, again) and torch.equal(aux, aux2)
    idx, cw = moe.router_topk(x @ router, 2)
    torch.testing.assert_close(cw.sum(dim=1), torch.ones(40))


def test_published_sizes_and_price():
    from repro_torch.serving import LMArm

    cfg = configs.get_config(ARCH)
    assert cfg.param_count() == 15_960_110_208
    assert cfg.layer_types == ["mla"] + ["mla_moe"] * 26
    assert cfg.segments() == [(("mla",), 1), (("mla_moe",), 26)]
    D = 2048
    assert 2 * D + cfg.mla_attention_params() == 13_767_168
    assert cfg.moe_ffn_params() == 571_080_768
    arm = LMArm("moonlight", LM(cfg, device="meta"), np.arange(4))
    assert arm.cost == pytest.approx(8.758e-7, rel=1e-3)
    danube = LMArm("danube", LM(configs.get_config("h2o-danube-1.8b"), device="meta"), np.arange(4))
    assert arm.cost > danube.cost
    assert sum(p.numel() for p in LM(cfg, device="meta").parameters()) == cfg.param_count()
    assert len(configs.list_archs()) == 10 and ARCH not in configs.list_archs()


def test_refused_configurations():
    base = configs.get_smoke_config(ARCH)
    with pytest.raises(TypeError, match="q_lora_rank"):   # queries at full rank only
        dataclasses.replace(base, q_lora_rank=16)
    with pytest.raises(ValueError, match="moe_ep"):
        dataclasses.replace(base, moe_ep=True)
    with pytest.raises(ValueError, match="router_scoring"):
        dataclasses.replace(base, router_scoring="softmax_topk")
    with pytest.raises(ValueError, match="kv_lora_rank is for mla blocks"):
        dataclasses.replace(configs.get_smoke_config("smollm-135m"), kv_lora_rank=32)


def test_out_of_scope_paths_raise_naming_the_block_types():
    from repro_torch import convert
    from repro_torch.distributed import sharding
    from repro_torch.launch import roofline
    from repro_torch.models.config import SHAPES

    cfg = configs.get_smoke_config(ARCH)
    lm = LM(cfg, device="cpu", seed=0)
    calls = [lambda: sharding.distribute_parameters(lm),
             lambda: convert.lm_params_from_jax({}, cfg),
             lambda: convert.cache_from_jax({}, cfg),
             lambda: roofline.analytic_flops(cfg, SHAPES["train_4k"]),
             lambda: lm.loss({"tokens": torch.zeros((1, 4), dtype=torch.long)})]
    for call in calls:
        with pytest.raises(ValueError, match="mla"):
            call()


def test_direct_and_blocked_attention_take_a_narrower_v():
    g = torch.Generator().manual_seed(6)
    B, S, H, G, hd, dv = 2, 9, 4, 2, 24, 16
    q, k = torch.randn(B, S, H, hd, generator=g), torch.randn(B, S, G, hd, generator=g)
    v = torch.randn(B, S, G, dv, generator=g)
    kk, vv = k.repeat_interleave(2, dim=2).double(), v.repeat_interleave(2, dim=2).double()
    s = torch.einsum("bshd,bthd->bhst", q.double(), kk) / np.sqrt(hd)
    s = s.masked_fill(~torch.tril(torch.ones(S, S, dtype=torch.bool)), float("-inf"))
    want = torch.einsum("bhst,bthd->bshd", torch.softmax(s, dim=-1), vv)
    for got in (ref.flash_attention_ref(q, k, v), ops.flash_attention(q, k, v),
                attention.blocked_attention(q, k, v, block_kv=4)):
        assert got.shape == (B, S, H, dv)
        torch.testing.assert_close(got.double(), want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="at most"):
        ops.flash_attention(q, k, torch.randn(B, S, G, hd + 8, generator=g))


@pytest.mark.cuda
def test_flash_attention_at_moonlights_shape_on_the_card():
    """One launch at B=128, S=127, H=G=16, q/k 192, v 128, bf16, against the
    plain version in f32: bf16's rounding of the output (2e-2, as the
    kernel tests hold bf16)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    dev = torch.device("cuda", 0)
    g = torch.Generator(device=dev).manual_seed(7)
    q, k = (torch.randn(128, 127, 16, 192, generator=g, device=dev).bfloat16() for _ in range(2))
    v = torch.randn(128, 127, 16, 128, generator=g, device=dev).bfloat16()
    before = ops.flash_attention.launches
    out = ops.flash_attention(q, k, v)
    assert ops.flash_attention.launches == before + 1 and out.shape == (128, 127, 16, 128)
    want = ref.flash_attention_ref(q.float(), k.float(), v.float())
    torch.testing.assert_close(out.float(), want, rtol=2e-2, atol=2e-2)
