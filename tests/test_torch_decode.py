"""The port's prefill, decode step and KV/recurrent caches against the JAX
package's, on the CPU in f32, for every architecture of the JAX registry.

Weights and caches are made by the JAX package and carried across by
``repro_torch.convert`` (``lm_params_from_jax``, ``cache_from_jax``;
``cache_to_jax`` brings the port's cache back for a leaf-by-leaf
comparison). Frontend archs (internvl2, musicgen) prefill after frontend
embeddings. Tolerance on logits and cache leaves: atol/rtol 1e-4, as in
``tests/test_torch_models.py``; ``pos``, the ring, int8 values and the
cache layout are held exactly. The ``SMOKE`` windows are 16, and a
prefill of 19 tokens (plus 3 decode steps) wraps the windowed rings.

The JAX package runs jitted, as its own tests run prefill and decode. The
card against the CPU, and the model kernels' ``h_last`` (the decode state
a prefill hands on) against their plain versions, are held in
``tests/test_torch_models_cuda.py``, which imports no JAX.
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
from repro.models import ModelConfig as JaxModelConfig
from repro.models import blocks as jblocks
from repro.models import rglru as jrglru
from repro.models import ssm as jssm
from repro_torch import configs, convert
from repro_torch.models import LM, ModelConfig, blocks, rglru, ssm

ARCHS = jconfigs.list_archs()
TOL = dict(rtol=1e-4, atol=1e-4)
PREFILL, STEPS = 19, 3


def _close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


def _replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)


def _inputs(cfg, B, S, seed):
    """tokens (B, S) int32 and, for frontend archs, (B, Lf, D) f32 embeddings."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    fe = (rng.normal(0, 1, (B, cfg.frontend_len, cfg.d_model)).astype(np.float32)
          if cfg.frontend != "none" else None)
    return tokens, fe


def _jfe(fe):
    return None if fe is None else jnp.asarray(fe)


def _tfe(fe):
    return None if fe is None else torch.from_numpy(fe)


def _assert_cache_equal(got: dict, want: dict, **tol):
    """``got`` (the port's cache through ``cache_to_jax``) against a JAX
    cache: ``pos`` and ring exactly, every leaf's shape and dtype exactly,
    int8 values exactly, float leaves within ``tol``."""
    assert int(got["pos"]) == int(want["pos"])
    if want["ring"] is None:
        assert got["ring"] is None
    else:
        np.testing.assert_array_equal(got["ring"], np.asarray(want["ring"]))
    assert len(got["segs"]) == len(want["segs"])
    for gs, ws in zip(got["segs"], want["segs"]):
        assert gs.keys() == ws.keys()
        for unit in ws:
            assert gs[unit].keys() == ws[unit].keys()
            for name, w in ws[unit].items():
                g, w = gs[unit][name], np.asarray(w)
                assert g.shape == w.shape and g.dtype == w.dtype, (unit, name)
                if w.dtype == np.int8:
                    np.testing.assert_array_equal(g, w)
                else:
                    _close(g, w, **tol)


@pytest.fixture(scope="module", params=ARCHS)
def smoke(request):
    """(arch, JAX config, port config, JAX params, port model on the CPU)."""
    jcfg = jconfigs.get_smoke_config(request.param)
    params = jax.jit(JaxLM(jcfg).init)(jax.random.key(0))
    cfg = configs.get_smoke_config(request.param)
    model = convert.lm_from_jax(jax.tree.map(np.asarray, params), cfg, "cpu")
    return request.param, jcfg, cfg, params, model


def _jax_prefill(jcfg, params, tokens, fe, extra_slots):
    fn = jax.jit(JaxLM(jcfg).prefill, static_argnames="extra_slots")
    return fn(params, jnp.asarray(tokens), _jfe(fe), extra_slots=extra_slots)


def test_prefill_matches_jax(smoke):
    """Logits and every cache leaf, ring order and ``pos`` included."""
    arch, jcfg, cfg, params, model = smoke
    tokens, fe = _inputs(cfg, 2, PREFILL, seed=1)
    want_logits, want_cache = _jax_prefill(jcfg, params, tokens, fe, STEPS)
    got_logits, cache = model.prefill(torch.from_numpy(tokens), _tfe(fe), extra_slots=STEPS)
    _close(got_logits, want_logits)
    Lf = 0 if fe is None else cfg.frontend_len
    assert cache["pos"] == PREFILL + Lf
    assert len(cache["layers"]) == cfg.num_layers
    _assert_cache_equal(convert.cache_to_jax(cache, cfg), want_cache)
    T = model.attn_cache_len(PREFILL + Lf)
    assert T == JaxLM(jcfg).attn_cache_len(PREFILL + Lf)
    if T:
        full = model.window <= 0
        assert cache["ring"].shape == (T + (STEPS if full else 0),)


def test_decode_from_jax_cache_matches_jax(smoke):
    """``STEPS`` decode steps from a JAX-made prefill cache: the logits of
    each step and the cache after it."""
    arch, jcfg, cfg, params, model = smoke
    tokens, fe = _inputs(cfg, 2, PREFILL + STEPS, seed=2)
    _, jcache = _jax_prefill(jcfg, params, tokens[:, :PREFILL], fe, STEPS)
    cache = convert.cache_from_jax(jax.tree.map(np.asarray, jcache), cfg, "cpu")
    jstep = jax.jit(JaxLM(jcfg).decode_step)
    for t in range(PREFILL, PREFILL + STEPS):
        want, jcache = jstep(params, jcache, jnp.asarray(tokens[:, t:t + 1]))
        got, same = model.decode_step(cache, torch.from_numpy(tokens[:, t:t + 1]))
        assert same is cache                       # updated in place
        _close(got, want)
        _assert_cache_equal(convert.cache_to_jax(cache, cfg), jcache)


def _decode_vs_forward(jcfg, cfg, S, seed):
    """``(JAX error, port error)`` of one decode step after a prefill of
    S - 1 tokens against the forward's last logits, both packages on the
    same weights (MoE capacity factor 8.0, so no token is dropped)."""
    if cfg.num_experts:
        jcfg = _replace(jcfg, expert_capacity_factor=8.0)
        cfg = _replace(cfg, expert_capacity_factor=8.0)
    jm = JaxLM(jcfg)
    params = jax.jit(jm.init)(jax.random.key(1))
    lf = cfg.frontend_len if cfg.frontend != "none" else 0
    tokens, fe = _inputs(cfg, 2, S - lf, seed=seed)
    logits = jax.jit(jm.forward)(params, jnp.asarray(tokens), _jfe(fe))
    _, jcache = jax.jit(jm.prefill)(params, jnp.asarray(tokens[:, :-1]), _jfe(fe))
    dl, jcache2 = jax.jit(jm.decode_step)(params, jcache, jnp.asarray(tokens[:, -1:]))
    assert int(jcache2["pos"]) == int(jcache["pos"]) + 1
    jerr = float(jnp.max(jnp.abs(dl - logits[:, -1])))

    model = convert.lm_from_jax(jax.tree.map(np.asarray, params), cfg, "cpu")
    with torch.inference_mode():
        full = model(torch.from_numpy(tokens).long(), _tfe(fe))
    _, cache = model.prefill(torch.from_numpy(tokens[:, :-1]), _tfe(fe))
    pos = cache["pos"]
    got, cache = model.decode_step(cache, torch.from_numpy(tokens[:, -1:]))
    assert cache["pos"] == pos + 1
    _close(got, dl)                                  # and the two packages agree
    return jerr, float((got - full[:, -1]).abs().max())


@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_decode_matches_full_forward(arch):
    """``tests/test_models.py::test_smoke_decode_matches_full_forward`` on
    both packages: prefill 19 positions (the windowed rings of 16 wrap),
    decode the 20th, against the forward's last logits, err < 2e-4."""
    jerr, err = _decode_vs_forward(jconfigs.get_smoke_config(arch),
                                   configs.get_smoke_config(arch), S=20, seed=0)
    assert jerr < 2e-4 and err < 2e-4, (arch, jerr, err)


# ---------------------------------------------------------------------------
# F4: a windowed prefill shorter than its window (ROADMAP Queue 3)
# ---------------------------------------------------------------------------

WINDOWED = ["h2o-danube-1.8b", "recurrentgemma-9b"]


@pytest.mark.parametrize("arch", WINDOWED)
def test_short_windowed_prefill_decodes_as_jax(arch):
    """F4, the behaviour both packages share: at S = 10 < window 16 the ring
    has T = 10 slots, and the first decoded token overwrites slot 0 (the
    key of position 0, still inside the window). The port's logits and
    cache equal JAX's, step by step."""
    jcfg = jconfigs.get_smoke_config(arch)
    cfg = configs.get_smoke_config(arch)
    params = jax.jit(JaxLM(jcfg).init)(jax.random.key(1))
    model = convert.lm_from_jax(jax.tree.map(np.asarray, params), cfg, "cpu")
    tokens, _ = _inputs(cfg, 2, 13, seed=4)
    want, jcache = _jax_prefill(jcfg, params, tokens[:, :10], None, 1)
    got, cache = model.prefill(torch.from_numpy(tokens[:, :10]))
    assert cache["ring"].shape == (10,) and model.window == 16
    _close(got, want)
    jstep = jax.jit(JaxLM(jcfg).decode_step)
    for t in range(10, 13):
        want, jcache = jstep(params, jcache, jnp.asarray(tokens[:, t:t + 1]))
        got, cache = model.decode_step(cache, torch.from_numpy(tokens[:, t:t + 1]))
        _close(got, want)
        _assert_cache_equal(convert.cache_to_jax(cache, cfg), jcache)


@pytest.mark.xfail(strict=True, reason="F4: a windowed ring of T = min(window, S) slots "
                   "overwrites position 0 while it is inside the window (ROADMAP Queue 3)")
@pytest.mark.parametrize("arch", WINDOWED)
def test_short_windowed_prefill_decode_matches_forward(arch):
    """Prefill 10 < window 16 positions, decode the 11th: both packages miss
    the forward's logits (measured on a CPU: 1.79 danube, 0.067
    recurrentgemma, equal on the two packages)."""
    jerr, err = _decode_vs_forward(jconfigs.get_smoke_config(arch),
                                   configs.get_smoke_config(arch), S=11, seed=0)
    assert jerr < 2e-4 or err < 2e-4, (arch, jerr, err)


# ---------------------------------------------------------------------------
# int8 KV cache (tests/test_perf_features.py on the port)
# ---------------------------------------------------------------------------

def _q8(num_layers, **kw):
    fields = dict(name="q8", family="dense", num_layers=num_layers, d_model=64, num_heads=4,
                  num_kv_heads=2, d_ff=128, vocab_size=256, kv_quant="int8", dtype="float32",
                  remat=False, **kw)
    return JaxModelConfig(**fields), ModelConfig(**fields)


def test_int8_kv_decode_close_and_argmax_stable():
    """``test_perf_features.py``'s case on both packages: the int8 prefill
    cache equal to JAX's (int8 values exactly, scales within 1e-6), the
    decode logits equal within 1e-4, and on the port rel < 0.05 of the
    forward with the same argmax."""
    jcfg, cfg = _q8(3, tie_embeddings=True)
    jm = JaxLM(jcfg)
    params = jm.init(jax.random.key(0))
    tokens = np.array(jax.random.randint(jax.random.key(1), (2, 32), 0, 256))
    _, jcache = jax.jit(jm.prefill)(params, jnp.asarray(tokens[:, :-1]))
    want, _ = jax.jit(jm.decode_step)(params, jcache, jnp.asarray(tokens[:, -1:]))
    model = convert.lm_from_jax(jax.tree.map(np.asarray, params), cfg, "cpu")
    _, cache = model.prefill(torch.from_numpy(tokens[:, :-1]))
    assert cache["layers"][0]["k"].dtype == torch.int8 and "k_scale" in cache["layers"][0]
    _assert_cache_equal(convert.cache_to_jax(cache, cfg), jcache, rtol=0, atol=1e-6)
    dl, _ = model.decode_step(cache, torch.from_numpy(tokens[:, -1:]))
    _close(dl, want)
    with torch.inference_mode():
        logits = model(torch.from_numpy(tokens).long())[:, -1]
    rel = float((dl - logits).abs().max() / logits.abs().max())
    assert rel < 0.05
    np.testing.assert_array_equal(dl.argmax(-1).numpy(), logits.argmax(-1).numpy())


@pytest.mark.parametrize("window,cache_len,prefilled", [
    (0, 16, 15), (0, 16, 0), (0, 9, 9), (8, 16, 15), (8, 16, 5), (8, 5, 3)])
def test_int8_kv_init_cache_shapes(window, cache_len, prefilled):
    """``test_perf_features.py``'s shapes, and the ring of
    ``init_cache(prefilled=...)`` equal to JAX's, windowed and not."""
    jcfg, cfg = _q8(2, window=window)
    want = JaxLM(jcfg).init_cache(batch=3, cache_len=cache_len, prefilled=prefilled)
    cache = LM(cfg, device="cpu").init_cache(batch=3, cache_len=cache_len, prefilled=prefilled)
    T = min(window, cache_len) if window else cache_len
    u0 = cache["layers"][0]
    assert u0["k"].dtype == torch.int8 and u0["k_scale"].shape == (3, T, 2, 1)
    assert jax.tree.map(np.asarray, want)["segs"][0]["u0"]["k_scale"].shape == (2, 3, T, 2, 1)
    _assert_cache_equal(convert.cache_to_jax(cache, cfg), want, rtol=0, atol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_matches_jax(arch):
    """Every arch's empty cache: leaves, shapes, dtypes, ring and ``pos``."""
    jcfg, cfg = jconfigs.get_smoke_config(arch), configs.get_smoke_config(arch)
    want = JaxLM(jcfg).init_cache(batch=2, cache_len=21, prefilled=19)
    cache = LM(cfg, device="cpu").init_cache(batch=2, cache_len=21, prefilled=19)
    _assert_cache_equal(convert.cache_to_jax(cache, cfg), want, rtol=0, atol=0)
    back = convert.cache_from_jax(jax.tree.map(np.asarray, want), cfg, "cpu")
    _assert_cache_equal(convert.cache_to_jax(back, cfg), want, rtol=0, atol=0)


def test_bf16_cache_round_trips_through_jax_layout():
    cfg = _replace(configs.get_smoke_config("recurrentgemma-9b"), dtype="bfloat16")
    cache = LM(cfg, device="cpu").init_cache(batch=2, cache_len=7)
    for layer in cache["layers"]:
        for name, t in layer.items():
            t.copy_(torch.randn(t.shape).to(t.dtype))
    back = convert.cache_from_jax(convert.cache_to_jax(cache, cfg), cfg, "cpu")
    for a, b in zip(cache["layers"], back["layers"]):
        assert a.keys() == b.keys()
        for name in a:
            assert a[name].dtype == b[name].dtype and torch.equal(a[name], b[name])


def test_quantize_kv_ties_bitwise():
    """Values at exact half steps of the scale round half to even on both
    packages, and every value and scale is bitwise JAX's (jitted)."""
    rng = np.random.default_rng(3)
    scale = np.float32(np.float32(100.0) * (np.float32(1.0) / np.float32(127.0))
                       + np.float32(1e-8))
    halves = (rng.integers(-126, 126, (2, 5, 3, 16)) + 0.5).astype(np.float32)
    x = (halves * scale).astype(np.float32)
    x[..., 0] = 100.0                                      # each row's max: scale as above
    x[0, 0, 0, 1] = -100.0
    exact_ties = (x / scale == halves) & (np.arange(16) > 1)
    assert exact_ties.sum() > 100                          # the case really holds ties
    jq, js = jax.jit(jblocks.quantize_kv)(jnp.asarray(x))
    q, s = blocks.quantize_kv(torch.from_numpy(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32 and s.shape == (2, 5, 3, 1)
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    even = np.where(exact_ties, q.numpy(), 0) % 2
    assert not even.any()                                  # half to even
    deq = blocks.dequantize_kv(q, s, torch.bfloat16)
    np.testing.assert_array_equal(
        deq.float().numpy(),
        np.asarray(jblocks.dequantize_kv(jq, js, jnp.bfloat16).astype(jnp.float32)))


# ---------------------------------------------------------------------------
# The block-level decode functions
# ---------------------------------------------------------------------------

def test_rglru_decode_step_matches_jax():
    rng = np.random.default_rng(5)
    D = 24
    x = rng.normal(0, 1, (3, D)).astype(np.float32)
    wr, wi = (rng.normal(0, D ** -0.5, (D, D)).astype(np.float32) for _ in range(2))
    br, bi = (rng.normal(0, 0.1, (D,)).astype(np.float32) for _ in range(2))
    lam = rng.normal(-6.0, 2.0, (D,)).astype(np.float32)
    h = rng.normal(0, 1, (3, D)).astype(np.float32)
    want = jrglru.rglru_decode_step(*map(jnp.asarray, (x, wr, wi, br, bi, lam, h)))
    state = torch.from_numpy(h.copy())
    got = rglru.rglru_decode_step(*map(torch.from_numpy, (x, wr, wi, br, bi, lam)), state)
    assert got[1] is state                                # updated in place
    for g, w in zip(got, want):
        _close(g, w)


def test_ssm_decode_step_matches_jax():
    rng = np.random.default_rng(6)
    B, Din, N = 3, 12, 4
    x = rng.normal(0, 1, (B, Din)).astype(np.float32)
    dt = (np.abs(rng.normal(0, 0.3, (B, Din))) + 0.01).astype(np.float32)
    A = -np.abs(rng.normal(1, 0.5, (Din, N))).astype(np.float32)
    Bv, Cv = (rng.normal(0, 1, (B, N)).astype(np.float32) for _ in range(2))
    Dk = rng.normal(0, 1, (Din,)).astype(np.float32)
    h = rng.normal(0, 1, (B, Din, N)).astype(np.float32)
    want = jssm.ssm_decode_step(*map(jnp.asarray, (x, dt, A, Bv, Cv, Dk, h)))
    state = torch.from_numpy(h.copy())
    got = ssm.ssm_decode_step(*map(torch.from_numpy, (x, dt, A, Bv, Cv, Dk)), state)
    assert got[1] is state
    for g, w in zip(got, want):
        _close(g, w)


def _attn_params(cfg, rng):
    D, H, G, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    shapes = {"wq": (D, H * hd), "wk": (D, G * hd), "wv": (D, G * hd), "wo": (H * hd, D)}
    return {k: (rng.normal(0, D ** -0.5, s)).astype(np.float32) for k, s in shapes.items()}


@pytest.mark.parametrize("window,quant", [(0, "none"), (0, "int8"), (8, "none"), (8, "int8")])
def test_attn_sublayer_decode_partly_empty_ring_matches_jax(window, quant):
    """One decode step into a cache of T slots (12, or the window's 8) of
    which 5 hold positions (an ``init_cache(prefilled=5)`` ring, the rest
    -1), against JAX's; then a step at a position past every slot (the
    last slot overwritten, or the ring wrapped with the window masking the
    oldest keys)."""
    jcfg, cfg = _q8(1, window=window)
    jcfg, cfg = _replace(jcfg, kv_quant=quant), _replace(cfg, kv_quant=quant)
    rng = np.random.default_rng(7)
    p = _attn_params(cfg, rng)
    T = window or 12
    ring = np.asarray(JaxLM(jcfg).init_cache(batch=2, cache_len=T, prefilled=5)["ring"])
    assert ring.shape == (T,) and (ring[5:] == -1).all()
    kv = rng.normal(0, 1, (2, T, 2, 16)).astype(np.float32)
    kv[:, 5:] = 0.0
    if quant == "int8":
        jq = [jblocks.quantize_kv(jnp.asarray(t)) for t in (kv, kv[::-1])]
        jcache = {"k": jq[0][0], "v": jq[1][0], "k_scale": jq[0][1], "v_scale": jq[1][1]}
    else:
        jcache = {"k": jnp.asarray(kv), "v": jnp.asarray(kv[::-1])}
    cache = {k: torch.from_numpy(np.array(v)) for k, v in jcache.items()}
    fn = jax.jit(jblocks.attn_sublayer_decode, static_argnames=("cfg", "window"))
    tring = torch.from_numpy(ring.copy())
    for pos in (5, 14):
        x = rng.normal(0, 1, (2, 1, 64)).astype(np.float32)
        want, jcache = fn({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), jcfg,
                          jcache, jnp.int32(pos), window, jnp.asarray(ring))
        got, same = blocks.attn_sublayer_decode({k: torch.from_numpy(v) for k, v in p.items()},
                                                torch.from_numpy(x), cfg, cache, pos, window,
                                                tring)
        assert same is cache
        _close(got, want)
        for name, w in jcache.items():
            if name in ("k", "v") and quant == "int8":
                np.testing.assert_array_equal(cache[name].numpy(), np.asarray(w))
            else:
                _close(cache[name], w, rtol=0, atol=1e-6)
        slot = blocks.decode_slot(pos, T, window)
        ring = np.where(np.arange(T) == slot, pos, ring).astype(np.int32)
        tring[slot] = pos
