"""The port's model substrate against the JAX package's, on the CPU in f32.

Weights are made by the JAX package's ``init_params`` and carried across
by ``repro_torch.convert.lm_params_from_jax``, so both packages run the
same numbers. Every architecture of the JAX registry is held, the
frontend ones (internvl2, musicgen) with frontend embeddings. Tolerance on
logits and block outputs: atol 1e-4, rtol 1e-4; only the order of f32
sums differs (matmul blocking, the sequential scans against JAX's
associative and chunked scans). Measured on this CPU: the ``SMOKE``
logits agree to 7e-7 (smollm), 2e-6 (recurrentgemma), 1.1e-5
(falcon-mamba) and at most 5.3e-6 for the seven others.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):      # removed in jax 0.9
    jax.experimental.enable_x64 = jax.enable_x64

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import LM as JaxLM
from repro.models import attention as jattention
from repro.models import blocks as jblocks
from repro.models import mlp as jmlp
from repro.models import rglru as jrglru
from repro.models import rotary as jrotary
from repro.models import ssm as jssm
from repro_torch import configs, convert
from repro_torch.models import LM, attention, blocks, init, mlp, rglru, rotary, ssm
from repro_torch.models.config import ModelConfig

ARCHS = jconfigs.list_archs()
TOL = dict(rtol=1e-4, atol=1e-4)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **(tol or TOL))


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    """(arch, JAX config, port config, JAX params, numpy params)."""
    jcfg = jconfigs.get_smoke_config(request.param)
    params = jax.jit(JaxLM(jcfg).init)(jax.random.key(0))
    return (request.param, jcfg, configs.get_smoke_config(request.param), params,
            jax.tree.map(np.asarray, params))


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_copied_verbatim(arch):
    """Every field of the JAX package's configuration has its value in the
    port's, and the port's own fields (latent attention, the sigmoid router,
    shared experts, leading dense layers) are those a port configuration of
    the JAX fields alone takes: its defaults."""
    for getter in ("get_config", "get_smoke_config"):
        want = dataclasses.asdict(getattr(jconfigs, getter)(arch))
        got = getattr(configs, getter)(arch)
        assert {k: v for k, v in dataclasses.asdict(got).items() if k in want} == want
        assert got == ModelConfig(**want)
    assert configs.get_config(arch).param_count() == jconfigs.get_config(arch).param_count()
    assert configs.get_config(arch).flops_per_token(128) == jconfigs.get_config(arch).flops_per_token(128)


def test_registry_lists_the_ported_archs_only():
    """The port's registry is the JAX package's: the same architectures in
    the same order; an unknown name still raises. (The name is kept from
    when the port's registry listed the three ported architectures only.)"""
    assert configs.list_archs() == jconfigs.list_archs()
    assert len(configs.list_archs()) == 10
    for getter in ("get_config", "get_smoke_config"):
        with pytest.raises(KeyError, match="unknown arch"):
            getattr(configs, getter)("no-such-model")


def test_forward_matches_jax(smoke):
    """The whole model's logits; frontend archs forward with frontend
    embeddings prepended."""
    arch, jcfg, cfg, params, pnp = smoke
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, jcfg.vocab_size, (2, 63)).astype(np.int32)
    fe = (rng.normal(0, 1, (2, cfg.frontend_len, cfg.d_model)).astype(np.float32)
          if cfg.frontend != "none" else None)
    want = np.asarray(jax.jit(JaxLM(jcfg).forward)(
        params, jnp.asarray(tokens), None if fe is None else jnp.asarray(fe)))
    model = convert.lm_from_jax(pnp, cfg, "cpu")
    with torch.inference_mode():
        got = model(torch.from_numpy(tokens).long(), None if fe is None else _t(fe))
    assert got.shape == want.shape and got.dtype == torch.float32
    assert got.shape[1] == 63 + (0 if fe is None else cfg.frontend_len)
    _close(got, want)


def test_layer_order_follows_segments(smoke):
    arch, jcfg, cfg, params, pnp = smoke
    model = convert.lm_from_jax(pnp, cfg, "cpu")
    assert [b.btype for b in model.layers] == cfg.layer_types
    i = 0
    for si, (unit, repeats) in enumerate(cfg.segments()):
        for r in range(repeats):
            for j in range(len(unit)):
                for name, leaf in pnp[f"seg{si}"][f"u{j}"].items():
                    np.testing.assert_array_equal(model.layers[i].params[name].numpy(), leaf[r])
                i += 1


def _layer(pnp, cfg, btype):
    """The first layer of type ``btype``: its JAX params and port params."""
    for si, (unit, _) in enumerate(cfg.segments()):
        for j, t in enumerate(unit):
            if t == btype:
                jp = {k: v[0] for k, v in pnp[f"seg{si}"][f"u{j}"].items()}
                return ({k: jnp.asarray(v) for k, v in jp.items()},
                        {k: _t(v) for k, v in jp.items()})
    return None


def test_blocks_match_jax(smoke):
    arch, jcfg, cfg, params, pnp = smoke
    x = np.random.default_rng(1).normal(0, 1, (2, 63, cfg.d_model)).astype(np.float32)
    window = 16 if "rec" in cfg.block_pattern else cfg.window
    seen = 0
    for btype in set(cfg.layer_types):
        jp, tp = _layer(pnp, cfg, btype)
        if btype == "moe":
            fn = jax.jit(lambda p, h: jblocks.moe_block(p, h, jcfg, window=window))
            got, aux = blocks.moe_block(tp, _t(x), cfg, window=window)
            want, _, want_aux = fn(jp, jnp.asarray(x))
            _close(got, want)
            _close(aux, want_aux)
            seen += 1
            continue
        if btype == "attn":
            fn = jax.jit(lambda p, h: jblocks.attn_block(p, h, jcfg, window=window)[0])
            got = blocks.attn_block(tp, _t(x), cfg, window=window)
        elif btype == "rec":
            fn = jax.jit(lambda p, h: jblocks.rec_block(p, h, jcfg)[0])
            got = blocks.rec_block(tp, _t(x), cfg)
        else:
            fn = jax.jit(lambda p, h: jblocks.ssm_block(p, h, jcfg)[0])
            got = blocks.ssm_block(tp, _t(x), cfg)
        want = fn(jp, jnp.asarray(x))
        _close(got, want)
        seen += 1
    assert seen == len(set(cfg.block_pattern))


def test_rmsnorm_and_rope_match_jax():
    rng = np.random.default_rng(2)
    x = rng.normal(0, 2, (2, 9, 48)).astype(np.float32)
    scale = rng.normal(0, 0.5, (48,)).astype(np.float32)
    _close(mlp.rmsnorm(_t(x), _t(scale), 1e-6), jmlp.rmsnorm(jnp.asarray(x), jnp.asarray(scale), 1e-6))
    q = rng.normal(0, 1, (2, 37, 3, 16)).astype(np.float32)
    pos = np.arange(37)
    for theta in (10000.0, 500.0):
        _close(rotary.apply_rope(_t(q), torch.arange(37), theta),
               jrotary.apply_rope(jnp.asarray(q), jnp.asarray(pos), theta), rtol=0, atol=1e-5)
    _close(rotary.rope_frequencies(16), jrotary.rope_frequencies(16), rtol=0, atol=0)


def test_mlps_match_jax():
    rng = np.random.default_rng(3)
    x, wg, wu, wd = (rng.normal(0, 0.3, s).astype(np.float32)
                     for s in ((2, 5, 16), (16, 32), (16, 32), (32, 16)))
    _close(mlp.swiglu(_t(x), _t(wg), _t(wu), _t(wd)),
           jmlp.swiglu(*map(jnp.asarray, (x, wg, wu, wd))))
    _close(mlp.gelu_mlp(_t(x), _t(wg), _t(wd)),     # jax.nn.gelu: the tanh approximation
           jmlp.gelu_mlp(*map(jnp.asarray, (x, wg, wd))))


def test_rglru_gates_and_conv_match_jax():
    rng = np.random.default_rng(4)
    D = 24
    x = rng.normal(0, 1, (2, 11, D)).astype(np.float32)
    wr, wi = (rng.normal(0, D ** -0.5, (D, D)).astype(np.float32) for _ in range(2))
    br, bi = (rng.normal(0, 0.1, (D,)).astype(np.float32) for _ in range(2))
    lam = rng.normal(-6.0, 2.0, (D,)).astype(np.float32)
    lam[0] = 4.0                       # strong decay: 1 - a^2 -> 1
    lam[1] = -30.0                     # no decay: 1 - a^2 hits the 1e-12 clamp
    got = rglru.rglru_gates(*map(_t, (x, wr, wi, br, bi, lam)))
    want = jrglru.rglru_gates(*map(jnp.asarray, (x, wr, wi, br, bi, lam)))
    for g, w in zip(got, want):
        _close(g, w)
    w = rng.normal(0, 0.5, (D, 4)).astype(np.float32)
    b = rng.normal(0, 0.1, (D,)).astype(np.float32)
    state = rng.normal(0, 1, (2, 3, D)).astype(np.float32)
    for st in (None, state):
        gy, gs = ssm.causal_conv1d(_t(x), _t(w), _t(b), None if st is None else _t(st))
        wy, ws = jssm.causal_conv1d(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b),
                                    None if st is None else jnp.asarray(st))
        _close(gy, wy)
        _close(gs, ws, rtol=0, atol=0)


def test_scans_in_model_form_match_jax():
    """``rglru_scan`` against JAX's associative scan and ``selective_scan``
    against JAX's chunked scan, from zero and from a given state."""
    rng = np.random.default_rng(5)
    la = -np.abs(rng.normal(0, 0.5, (2, 29, 16))).astype(np.float32)
    u = rng.normal(0, 1, (2, 29, 16)).astype(np.float32)
    h0 = rng.normal(0, 1, (2, 16)).astype(np.float32)
    for h in (None, h0):
        got = rglru.rglru_scan(_t(la), _t(u), None if h is None else _t(h))
        want = jax.jit(jrglru.rglru_scan)(jnp.asarray(la), jnp.asarray(u),
                                          None if h is None else jnp.asarray(h))
        for g, w in zip(got, want):
            _close(g, w)
    B, S, Din, N = 2, 29, 12, 4
    x = rng.normal(0, 1, (B, S, Din)).astype(np.float32)
    dt = np.abs(rng.normal(0, 0.3, (B, S, Din))).astype(np.float32) + 0.01
    A = -np.abs(rng.normal(1, 0.5, (Din, N))).astype(np.float32)
    Bm, Cm = (rng.normal(0, 1, (B, S, N)).astype(np.float32) for _ in range(2))
    Dk = rng.normal(0, 1, (Din,)).astype(np.float32)
    hs = rng.normal(0, 1, (B, Din, N)).astype(np.float32)
    for h in (None, hs):
        got = ssm.selective_scan(*map(_t, (x, dt, A, Bm, Cm, Dk)), h0=None if h is None else _t(h), chunk=8)
        want = jax.jit(jssm.selective_scan, static_argnames="chunk")(
            *map(jnp.asarray, (x, dt, A, Bm, Cm, Dk)), h0=None if h is None else jnp.asarray(h),
            chunk=8)
        for g, w in zip(got, want):
            _close(g, w)


@pytest.mark.parametrize("window,buckets", [(0, 0), (24, 0), (0, 4)])
def test_cpu_dispatch_above_blocked_threshold_matches_jax(window, buckets):
    """S > blocked_threshold takes the blocked (or bucketed) path on the CPU,
    as in JAX."""
    rng = np.random.default_rng(6)
    q = rng.normal(0, 1, (1, 96, 4, 16)).astype(np.float32)
    k, v = (rng.normal(0, 1, (1, 96, 2, 16)).astype(np.float32) for _ in range(2))
    kw = dict(causal=True, window=window, blocked_threshold=64, block_kv=32, causal_buckets=buckets)
    got = attention.attention(_t(q), _t(k), _t(v), **kw)
    want = jattention.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), **kw)
    _close(got, want, rtol=0, atol=2e-5)
    blocked = jattention.blocked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                           causal=True, window=window, block_kv=32)
    _close(got, blocked, rtol=0, atol=2e-5)


def _shapes(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_shapes(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = (tuple(v.shape), str(v.dtype).replace("torch.", ""))
    return out


@pytest.mark.parametrize("arch,smoke_cfg", [(a, True) for a in ARCHS] + [("smollm-135m", False)])
def test_init_shapes_match_jax_param_shapes(arch, smoke_cfg):
    get = "get_smoke_config" if smoke_cfg else "get_config"
    cfg, jcfg = getattr(configs, get)(arch), getattr(jconfigs, get)(arch)
    gen = torch.Generator().manual_seed(0)
    got = _shapes(init.init_params(gen, cfg))
    want = _shapes(JaxLM(jcfg).param_shapes())
    assert got == want
    assert init.padded_vocab(cfg) == got["embed/tok"][0][0]


def test_init_distributions(smoke):
    arch, jcfg, cfg, params, pnp = smoke
    model = LM(cfg, device="cpu", seed=1)
    assert torch.allclose(model.tok.float().std(), torch.tensor(0.02), rtol=0.05)
    layer = model.layers[0].params
    if "wq" in layer:
        assert torch.allclose(layer["wq"].std(), torch.tensor(cfg.d_model ** -0.5), rtol=0.1)
    if "lam" in layer:     # Griffin: the decay at gate 1, exp(-8 softplus(lam)), in (0.9, 0.999)
        u = torch.exp(-8.0 * torch.nn.functional.softplus(layer["lam"]))
        assert (u > 0.9 - 1e-5).all() and (u < 0.999 + 1e-5).all()
    if "a_log" in layer:                              # deterministic: log(1..N), to 1 ulp
        np.testing.assert_allclose(layer["a_log"].numpy(), pnp["seg0"]["u0"]["a_log"][0],
                                   rtol=2e-7, atol=0)
    again = LM(cfg, device="cpu", seed=1)
    assert torch.equal(again.tok, model.tok)          # seeded: the same draws


def test_lm_rejects_layer_count_mismatch(smoke):
    arch, jcfg, cfg, params, pnp = smoke
    p = convert.lm_params_from_jax(pnp, cfg)
    p["layers"] = p["layers"][:-1]
    with pytest.raises(ValueError, match="layers"):
        LM(cfg, device="cpu", params=p)
