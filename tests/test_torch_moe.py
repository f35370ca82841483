"""The port's mixture-of-experts layer against the JAX package's, on the CPU
in f32: ``router_topk``, ``capacity_for``, ``moe_mlp`` (with and without
capacity drops), ``moe_block``, gradients through a MoE layer, and GELU
experts (no ``ewu``).

Tolerances: outputs and aux within atol 1e-5 and rtol 1e-5; only the order
of f32 sums differs (matmul blocking, the sum over the k slots). The
expert ids must be equal: a near tie between the k-th and (k+1)-th router
logit could send a token elsewhere in one framework, so each case prints
the smallest such gap beside the check. Gradients within atol 1e-5, rtol
1e-4 (they add up both the combine path and the aux path).
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
from repro.models import blocks as jblocks
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.models import blocks, capacity_for, moe_mlp, router_topk

TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


def _t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def _close(got, want, **tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), **(tol or TOL))


def _weights(T, D, E, F, gated=True, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (T, D)).astype(np.float32)
    rw = rng.normal(0, D ** -0.5, (D, E)).astype(np.float32)
    wg = rng.normal(0, D ** -0.5, (E, D, F)).astype(np.float32)
    wu = rng.normal(0, D ** -0.5, (E, D, F)).astype(np.float32) if gated else None
    wd = rng.normal(0, F ** -0.5, (E, F, D)).astype(np.float32)
    return x, rw, wg, wu, wd


def _ids_and_gap(x, rw, k):
    """JAX's and the port's expert ids for the router input, and the
    smallest gap between the k-th and (k+1)-th logit."""
    jl = jnp.einsum("td,de->te", jnp.asarray(x), jnp.asarray(rw))
    jidx, jw = jmoe.router_topk(jl, k)
    tidx, tw = router_topk(_t(x) @ _t(rw), k)
    top = np.sort(np.asarray(jl), axis=1)[:, ::-1]
    return np.asarray(jidx), tidx.numpy(), float((top[:, k - 1] - top[:, k]).min())


def _drops(ids, E, C):
    """How many (token, slot) pairs rank past the capacity in arrival order."""
    flat = ids.reshape(-1)
    seen = np.zeros(E, np.int64)
    dropped = 0
    for e in flat:
        dropped += seen[e] >= C
        seen[e] += 1
    return int(dropped)


def test_router_topk_matches_jax_ties_included():
    rng = np.random.default_rng(1)
    logits = rng.normal(0, 1, (50, 12)).astype(np.float32)
    logits[:10] = np.round(logits[:10])                    # many exact ties
    logits[10] = 0.5                                       # every expert tied
    logits[11, ::2] = -0.0                                 # signed zeros: -0 ranks below +0
    logits[11, 1::2] = 0.0
    for k in (1, 2, 6, 12):
        jidx, jw = jmoe.router_topk(jnp.asarray(logits), k)
        idx, w = router_topk(_t(logits), k)
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        assert w.dtype == torch.float32
        _close(w, jw, rtol=0, atol=1e-7)


@pytest.mark.parametrize("tokens", [1, 7, 64, 254, 8128])
def test_capacity_for_matches_jax(tokens):
    for E, k, f in ((4, 2, 1.25), (8, 2, 8.0), (32, 8, 1.25), (64, 6, 1.25), (64, 6, 0.1)):
        got = capacity_for(tokens, E, k, f)
        assert got == jmoe.capacity_for(tokens, E, k, f)
        assert got >= 8 and got % 8 == 0
    assert capacity_for(8128, 32, 8, 1.25) == 2544     # granite-moe at 64 x 127 tokens
    assert capacity_for(8128, 64, 6, 1.25) == 960      # moonshot at 64 x 127 tokens


@pytest.mark.parametrize("factor,drops", [(1.25, True), (8.0, False)])
def test_moe_mlp_matches_jax(factor, drops):
    """Output and aux within 1e-5, expert ids equal; at factor 1.25 pairs
    are dropped past the capacity, at factor 8 none is."""
    T, D, E, F, k = 96, 32, 8, 48, 2
    x, rw, wg, wu, wd = _weights(T, D, E, F, seed=2)
    x[:, 0] += 3.0 * np.linspace(0, 1, T, dtype=np.float32)   # skew the load onto few experts
    rw[0] = np.abs(rw[0]) * np.linspace(1, 0, E, dtype=np.float32)
    jidx, tidx, gap = _ids_and_gap(x, rw, k)
    print(f"factor {factor}: smallest top-{k} gap {gap:.3g}")
    np.testing.assert_array_equal(tidx, jidx)
    C = capacity_for(T, E, k, factor)
    assert (_drops(jidx, E, C) > 0) == drops
    want, want_aux = jax.jit(lambda *a: jmoe.moe_mlp(*a, k=k, capacity_factor=factor))(
        *map(jnp.asarray, (x, rw, wg, wu, wd)))
    got, aux = moe_mlp(*map(_t, (x, rw, wg, wu, wd)), k, factor)
    assert got.shape == (T, D) and got.dtype == torch.float32 and aux.dtype == torch.float32
    _close(got, want)
    _close(aux, want_aux)


def test_moe_mlp_gelu_experts_match_jax():
    """mlp_variant "gelu": no ``ewu``, tanh-approximated GELU experts."""
    T, D, E, F, k = 64, 24, 4, 40, 2
    x, rw, wg, _, wd = _weights(T, D, E, F, gated=False, seed=3)
    jidx, tidx, gap = _ids_and_gap(x, rw, k)
    print(f"gelu experts: smallest top-{k} gap {gap:.3g}")
    np.testing.assert_array_equal(tidx, jidx)
    want, want_aux = jax.jit(lambda a, b, c, d: jmoe.moe_mlp(a, b, c, None, d, k=k))(
        *map(jnp.asarray, (x, rw, wg, wd)))
    got, aux = moe_mlp(_t(x), _t(rw), _t(wg), None, _t(wd), k)
    _close(got, want)
    _close(aux, want_aux)


def _moe_layer(arch, **changes):
    """(JAX config, port config, JAX layer params, port layer params) of the
    first layer of ``arch``'s SMOKE config (JAX init)."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config(arch), **changes)
    cfg = dataclasses.replace(configs.get_smoke_config(arch), **changes)
    params = jax.jit(JaxLM(jcfg).init)(jax.random.key(4))
    jp = {k: v[0] for k, v in params["seg0"]["u0"].items()}
    return jcfg, cfg, jp, {k: _t(v) for k, v in jp.items()}


@pytest.mark.parametrize("arch,changes", [
    ("granite-moe-1b-a400m", {}),
    ("moonshot-v1-16b-a3b", {}),
    ("granite-moe-1b-a400m", {"mlp_variant": "gelu"}),      # no ewu
])
def test_moe_block_matches_jax(arch, changes):
    jcfg, cfg, jp, tp = _moe_layer(arch, **changes)
    assert ("ewu" in tp) == (cfg.mlp_variant == "swiglu")
    x = np.random.default_rng(5).normal(0, 1, (2, 29, cfg.d_model)).astype(np.float32)
    want, _, want_aux = jax.jit(lambda p, h: jblocks.moe_block(p, h, jcfg, window=cfg.window))(
        jp, jnp.asarray(x))
    got, aux = blocks.moe_block(tp, _t(x), cfg, window=cfg.window)
    _close(got, want)
    _close(aux, want_aux)


@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "moonshot-v1-16b-a3b"])
def test_moe_block_gradients_match_jax(arch):
    """d/d(x, every parameter) of sum(out * u) + aux through a MoE layer,
    against ``jax.grad`` of the same function."""
    jcfg, cfg, jp, tp = _moe_layer(arch)
    rng = np.random.default_rng(6)
    x = rng.normal(0, 1, (2, 21, cfg.d_model)).astype(np.float32)
    u = rng.normal(0, 1, x.shape).astype(np.float32)

    def jfn(p, h):
        out, _, aux = jblocks.moe_block(p, h, jcfg, window=cfg.window)
        return jnp.sum(out * jnp.asarray(u)) + aux

    jgp, jgx = jax.jit(jax.grad(jfn, argnums=(0, 1)))(jp, jnp.asarray(x))
    leaves = {k: v.clone().requires_grad_() for k, v in tp.items()}
    xt = _t(x).requires_grad_()
    out, aux = blocks.moe_block(leaves, xt, cfg, window=cfg.window)
    names = list(leaves)
    grads = torch.autograd.grad((out * _t(u)).sum() + aux, [xt] + [leaves[n] for n in names])
    _close(grads[0], jgx, **GRAD_TOL)
    for name, g in zip(names, grads[1:]):
        assert float(g.abs().max()) > 0, name
        np.testing.assert_allclose(g.numpy(), np.asarray(jgp[name]), err_msg=name, **GRAD_TOL)
