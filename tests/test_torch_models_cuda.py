"""On a CUDA card only: the model substrate on the card against the port on
the CPU — prefill and decode per block type, the decode state the model
kernels hand on (``h_last``), the MoE layer and every architecture's
``SMOKE`` forward.

Imports neither ``jax`` nor ``repro``, so it runs on a machine with only
the port's dependencies:

    THRIFTLINT_TRACER_GUARD=0 PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_models_cuda.py

Every test carries the ``cuda`` marker and skips, with its reason, where
there is no CUDA device. TF32 is off: f32 results are compared. Card
against CPU: f32 sums in other orders only, so logits and cache leaves
within 1e-4 (the models' tolerance in ``tests/test_torch_models.py``).
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import ops, ref
from repro_torch.models import LM, moe_mlp, router_topk

pytestmark = pytest.mark.cuda

TOL = dict(rtol=1e-4, atol=1e-4)
PREFILL, STEPS = 19, 3
NEW_ARCHS = ["h2o-danube-1.8b", "qwen1.5-110b", "starcoder2-7b", "granite-moe-1b-a400m",
             "moonshot-v1-16b-a3b", "internvl2-2b", "musicgen-medium"]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


def _pair(cfg, dev, seed):
    """The same weights on the CPU and on the card."""
    cpu = LM(cfg, device="cpu", seed=seed)
    return cpu, copy.deepcopy(cpu).to(dev)


def _inputs(cfg, S, seed):
    rng = np.random.default_rng(seed)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, S)))
    fe = (torch.as_tensor(rng.normal(0, 1, (2, cfg.frontend_len, cfg.d_model)),
                          dtype=torch.float32) if cfg.frontend != "none" else None)
    return tokens, fe


def _assert_caches_close(got: dict, want: dict):
    assert got["pos"] == want["pos"]
    if want["ring"] is None:
        assert got["ring"] is None
    else:
        assert torch.equal(got["ring"].cpu(), want["ring"])
    assert len(got["layers"]) == len(want["layers"])
    for g, w in zip(got["layers"], want["layers"]):
        assert g.keys() == w.keys()
        for name in w:
            assert g[name].dtype == w[name].dtype and g[name].shape == w[name].shape
            torch.testing.assert_close(g[name].cpu(), w[name], **TOL)


@pytest.mark.parametrize("arch", ["smollm-135m", "recurrentgemma-9b", "falcon-mamba-7b",
                                  "granite-moe-1b-a400m", "internvl2-2b"])
def test_prefill_and_decode_card_matches_cpu(cuda, arch):
    """A SMOKE model of each block type (attn; rec with local attn; ssm;
    moe; attn after frontend embeddings), f32: prefill 19 tokens with 3
    extra slots, decode 3, the logits and every cache leaf card vs CPU
    after each; the prefill goes through the kernels its blocks need, the
    decode steps through none."""
    cfg = configs.get_smoke_config(arch)
    cpu, card = _pair(cfg, cuda, seed=3)
    tokens, fe = _inputs(cfg, PREFILL + STEPS, seed=5)
    ops.reset_launch_counts()
    got, gc = card.prefill(tokens[:, :PREFILL].to(cuda), None if fe is None else fe.to(cuda),
                           extra_slots=STEPS)
    launched = {n: getattr(ops, n).launches for n in ("flash_attention", "rglru_scan",
                                                       "mamba_scan")}
    want, wc = cpu.prefill(tokens[:, :PREFILL], fe, extra_slots=STEPS)
    torch.testing.assert_close(got.cpu(), want, **TOL)
    _assert_caches_close(gc, wc)
    ops.reset_launch_counts()
    for t in range(PREFILL, PREFILL + STEPS):
        got, gc = card.decode_step(gc, tokens[:, t:t + 1].to(cuda))
        want, wc = cpu.decode_step(wc, tokens[:, t:t + 1])
        torch.testing.assert_close(got.cpu(), want, **TOL)
        _assert_caches_close(gc, wc)
    assert ops.flash_attention.launches == ops.rglru_scan.launches == ops.mamba_scan.launches == 0
    types = set(cfg.layer_types)
    assert (launched["flash_attention"] > 0) == bool(types & {"attn", "moe"})
    assert (launched["rglru_scan"] > 0) == ("rec" in types)
    assert (launched["mamba_scan"] > 0) == ("ssm" in types)


def test_int8_cache_card_matches_cpu(cuda):
    """smollm's SMOKE config with an int8 KV cache: scales within 1e-6 and
    int8 values at most one step apart card vs CPU (a value at a rounding
    tie may round either way when the f32 sums differ in the last bits),
    logits within 1e-3 (phase 8's card-vs-CPU gate)."""
    cfg = dataclasses.replace(configs.get_smoke_config("smollm-135m"), kv_quant="int8")
    cpu, card = _pair(cfg, cuda, seed=4)
    tokens, _ = _inputs(cfg, PREFILL + STEPS, seed=6)
    got, gc = card.prefill(tokens[:, :PREFILL].to(cuda), extra_slots=STEPS)
    want, wc = cpu.prefill(tokens[:, :PREFILL], extra_slots=STEPS)
    for t in range(PREFILL, PREFILL + STEPS + 1):
        torch.testing.assert_close(got.cpu(), want, rtol=0, atol=1e-3)
        for g, w in zip(gc["layers"], wc["layers"]):
            for name in ("k", "v"):
                assert g[name].dtype == torch.int8
                assert int((g[name].cpu().int() - w[name].int()).abs().max()) <= 1
                torch.testing.assert_close(g[f"{name}_scale"].cpu(), w[f"{name}_scale"],
                                           rtol=0, atol=1e-6)
        if t < PREFILL + STEPS:
            got, gc = card.decode_step(gc, tokens[:, t:t + 1].to(cuda))
            want, wc = cpu.decode_step(wc, tokens[:, t:t + 1])


@pytest.mark.parametrize("S", [1, 5, 17, 37])
@pytest.mark.parametrize("with_h0", [False, True])
def test_rglru_scan_h_last_card_matches_plain(cuda, S, with_h0):
    """The decode state a prefill hands on: ``h_last`` at S = 1, at S not a
    multiple of the unrolled loop's 4 steps, from zeros and from a non-zero
    h0, within 1e-5 (the kernel's tolerance) of the plain version, and
    equal to the kernel's own last h."""
    g = torch.Generator(device=cuda).manual_seed(S)
    la = -torch.rand((3, S, 200), generator=g, device=cuda)
    u = torch.randn((3, S, 200), generator=g, device=cuda)
    h0 = (torch.randn((3, 200), generator=g, device=cuda) if with_h0
          else torch.zeros((3, 200), device=cuda))
    h, h_last = ops.rglru_scan(la, u, h0)
    wh, wl = ref.rglru_scan_ref(la, u, h0)
    torch.testing.assert_close(h_last, wl, rtol=0, atol=1e-5)
    torch.testing.assert_close(h, wh, rtol=0, atol=1e-5)
    assert torch.equal(h_last, h[:, -1])


@pytest.mark.parametrize("S", [1, 5, 17, 37])
@pytest.mark.parametrize("with_h0", [False, True])
def test_mamba_scan_h_last_card_matches_plain(cuda, S, with_h0):
    """``mamba_scan``'s ``h_last`` at S = 1, at S not a multiple of the
    kernel's 16-step chunk, from None and from a non-zero h0, within 3e-4
    (the Mamba scan's tolerance) of the plain version."""
    g = torch.Generator(device=cuda).manual_seed(100 + S)
    B, Din, N = 2, 96, 8
    x = torch.randn((B, S, Din), generator=g, device=cuda)
    dt = torch.rand((B, S, Din), generator=g, device=cuda) * 0.3 + 0.01
    A = -torch.rand((Din, N), generator=g, device=cuda) - 0.5
    Bm, Cm = (torch.randn((B, S, N), generator=g, device=cuda) for _ in range(2))
    Dk = torch.randn((Din,), generator=g, device=cuda)
    h0 = torch.randn((B, Din, N), generator=g, device=cuda) if with_h0 else None
    y, h_last = ops.mamba_scan(x, dt, A, Bm, Cm, Dk, h0)
    wy, wl = ref.mamba_scan_ref(x, dt, A, Bm, Cm, Dk, h0)
    torch.testing.assert_close(h_last, wl, rtol=0, atol=3e-4)
    torch.testing.assert_close(y, wy, rtol=0, atol=3e-4)


@pytest.mark.parametrize("E,k,factor,T", [(8, 2, 1.25, 64), (32, 8, 1.25, 254),
                                          (64, 6, 8.0, 100)])
def test_moe_mlp_card_matches_cpu(cuda, E, k, factor, T):
    """The MoE layer card vs CPU in f32: every token picks the same experts
    in the same order (router logits in f32, TF32 off), the output and aux
    loss within 1e-4; granite's (32, 8) and moonshot's (64, 6) routing."""
    rng = np.random.default_rng(E + k)
    D, F = 48, 64
    x, rw = (torch.as_tensor(rng.normal(0, 1, s), dtype=torch.float32) for s in ((T, D), (D, E)))
    wg, wu = (torch.as_tensor(rng.normal(0, 0.2, (E, D, F)), dtype=torch.float32)
              for _ in range(2))
    wd = torch.as_tensor(rng.normal(0, 0.2, (E, F, D)), dtype=torch.float32)
    want, want_aux = moe_mlp(x, rw, wg, wu, wd, k, factor)
    got, got_aux = moe_mlp(*(t.to(cuda) for t in (x, rw, wg, wu, wd)), k, factor)
    ids_c, _ = router_topk(x @ rw, k)
    ids_g, _ = router_topk(x.to(cuda) @ rw.to(cuda), k)
    assert torch.equal(ids_g.cpu(), ids_c)
    torch.testing.assert_close(got.cpu(), want, **TOL)
    torch.testing.assert_close(got_aux.cpu(), want_aux, **TOL)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_smoke_forward_card_matches_cpu(cuda, arch):
    """Each of the seven architectures PR 20 added: its SMOKE config's f32
    forward on the card (flash for its attention) against the CPU within
    1e-4, frontend archs after frontend embeddings."""
    cfg = configs.get_smoke_config(arch)
    cpu, card = _pair(cfg, cuda, seed=7)
    tokens, fe = _inputs(cfg, 63, seed=8)
    ops.reset_launch_counts()
    with torch.inference_mode():
        got = card(tokens.to(cuda), None if fe is None else fe.to(cuda))
        want = cpu(tokens, fe)
    assert ops.flash_attention.launches == cfg.num_layers
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.cpu(), want, **TOL)
