"""The port's training step against the JAX package's, on the CPU in f32.

Weights and optimizer state come from JAX's ``init_train_state`` and cross
by ``repro_torch.convert.train_state_from_jax``; both packages then take 3
steps on the same numpy batches (``tests/test_models.py``'s train-step,
microbatch, compression and loss-chunking cases, held to the reference).

Tolerances, from measurements on this CPU:

* losses and ``grad_norm`` agree to rel 1e-5 at every step (measured at
  most 1.1e-6);
* the gradients of the two frameworks differ by up to 4e-6 of each
  tensor's largest entry (matmul and scan sums in other orders). AdamW maps
  g to about lr g / (|g| + eps), so where |g| is near eps a difference d in
  g moves the update by lr d / eps. With the default eps 1e-8 that
  magnifies f32 rounding by 1e5: the parameters and master weights of the
  two packages part by up to 3.6e-5 after 3 steps at lr 1e-3 (measured,
  recurrentgemma; the moments by 5.1e-7). The parity runs therefore use
  eps 1e-6, where the final parameters and master weights agree within
  7.2e-6 (measured) and the moments within 7.2e-8: atol 1e-5 for all of
  them. The default eps, which the trainer runs, is held too: losses and
  ``grad_norm`` at rel 1e-5 (measured at most 3.7e-6), parameters and
  master weights at atol 1e-4, moments at atol 1e-5;
* the codecs are discontinuous (an int8 level or a top-k membership flips
  when a gradient entry moves by a rounding), so they are held on identical
  gradients: the JAX package's ``compress_grads`` + ``adamw_update`` and
  the port's on the same JAX gradients over 3 steps, residuals included,
  atol 1e-5 (measured at most 1.2e-7); and the port's train step with a
  codec equals that chain of the port's own functions exactly.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):      # removed in jax 0.9
    jax.experimental.enable_x64 = jax.enable_x64

import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import LM as JaxLM
from repro.training import CompressionConfig as JComp
from repro.training import OptimizerConfig as JOpt
from repro.training import adamw_update as j_adamw_update
from repro.training import compress_grads as j_compress_grads
from repro.training import global_norm as j_global_norm
from repro.training import init_train_state as j_init_train_state
from repro.training import lr_at as j_lr_at
from repro.training import make_train_step as j_make_train_step
from repro_torch import configs, convert
from repro_torch.models import LM, named_params
from repro_torch.training import (CompressionConfig, OptimizerConfig, adamw_update,
                                  compress_grads, global_norm, init_train_state, lr_at,
                                  make_train_step)
from _torch_serving import one_torch_thread  # noqa: F401  (autouse: torch on one CPU thread)

ARCHS = ["smollm-135m", "recurrentgemma-9b", "falcon-mamba-7b"]
STEPS = 3
OPT = dict(lr=1e-3, warmup_steps=1, eps=1e-6)      # eps: see the module docstring
REL = 1e-5
ATOL = 1e-5
DEFAULT_EPS_PARAM_ATOL = 1e-4                       # eps 1e-8: see the module docstring


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _batches(cfg, n=STEPS, B=4, S=24, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32) for _ in range(n)]


def _configs(arch, **changes):
    return (dataclasses.replace(jconfigs.get_smoke_config(arch), **changes),
            dataclasses.replace(configs.get_smoke_config(arch), **changes))


@functools.lru_cache(maxsize=None)
def _jax_state(arch, codec="none", **changes):
    """``(JAX model, params, opt state)`` of JAX's ``init_train_state`` at key
    0, made once per configuration (JAX arrays are immutable, so tests share
    them)."""
    jmodel = JaxLM(_configs(arch, **changes)[0])
    jparams, jopt = jax.jit(lambda k: j_init_train_state(jmodel, k, JComp(codec=codec)))(
        jax.random.key(0))
    return jmodel, jparams, jopt


def _port_state(jparams, jopt, cfg, comp=CompressionConfig()):
    """A port model holding the JAX weights and the JAX optimizer state."""
    tparams, topt = convert.train_state_from_jax(_np(jparams), _np(jopt), cfg)
    model = LM(cfg, "cpu", params=tparams)
    params, _ = init_train_state(model, comp)
    return model, params, topt


def _named(tree, cfg):
    return named_params(convert.lm_params_from_jax(_np(tree), cfg))


def _assert_state(params, opt, jparams, jopt, cfg, param_atol=ATOL, param_atol_by_name=None):
    """Final parameters and master weights within ``param_atol`` (or the
    tensor's own entry of ``param_atol_by_name``), moments and residuals
    within ``ATOL``."""
    jp, jo = _named(jparams, cfg), convert.train_state_from_jax(_np(jparams), _np(jopt), cfg)[1]
    for name, p in params.items():
        atol = (param_atol_by_name or {}).get(name, param_atol)
        np.testing.assert_allclose(p.detach().numpy(), jp[name].numpy(), rtol=0,
                                   atol=atol, err_msg=name)
        for key in ("m", "v", "master") + (("residuals",) if "residuals" in jo else ()):
            np.testing.assert_allclose(opt[key][name].numpy(), jo[key][name].numpy(), rtol=0,
                                       atol=atol if key == "master" else ATOL,
                                       err_msg=f"{key} {name}")
    assert int(opt["step"]) == int(jo["step"])


def _run_both(arch, steps=STEPS, B=4, opt_kw=OPT, param_atol=ATOL, **changes):
    """``steps`` train steps of each package from the same JAX state; asserts
    loss and grad_norm per step and the final state."""
    cfg = _configs(arch, **changes)[1]
    jmodel, jparams, jopt = _jax_state(arch, **changes)
    model, params, opt = _port_state(jparams, jopt, cfg)
    jstep = jax.jit(j_make_train_step(jmodel, JOpt(**opt_kw)))
    step = make_train_step(model, OptimizerConfig(**opt_kw))
    for s, toks in enumerate(_batches(cfg, steps, B=B)):
        jparams, jopt, jm = jstep(jparams, jopt, {"tokens": jnp.asarray(toks)})
        params, opt, m = step(params, opt, {"tokens": torch.from_numpy(toks)})
        for key in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=REL,
                                       err_msg=f"{arch} step {s} {key}")
    _assert_state(params, opt, jparams, jopt, cfg, param_atol)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch):
    _run_both(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax_at_default_eps(arch):
    """AdamW's default eps 1e-8, as the trainer runs it: parameters and
    master weights within 1e-4 (see the module docstring)."""
    _run_both(arch, opt_kw=dict(lr=1e-3, warmup_steps=1), param_atol=DEFAULT_EPS_PARAM_ATOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_microbatched_train_step_matches_jax(arch):
    """num_microbatches=2: f32 gradients summed over two halves of the batch
    (tests/test_models.py::test_microbatch_grad_equivalence, on the port)."""
    _run_both(arch, num_microbatches=2)


def test_microbatches_equal_one_batch():
    """Port only: two microbatches give the single batch's parameters
    (atol 2e-5, the reference's own test)."""
    out = []
    for m in (1, 2):
        cfg = _configs("smollm-135m", num_microbatches=m)[1]
        _, jparams, jopt = _jax_state("smollm-135m", num_microbatches=m)
        model, params, opt = _port_state(jparams, jopt, cfg)
        params, _, _ = make_train_step(model, OptimizerConfig(lr=1e-3))(
            params, opt, {"tokens": torch.from_numpy(_batches(cfg, 1)[0])})
        out.append({k: p.detach().clone() for k, p in params.items()})
    for k in out[0]:
        np.testing.assert_allclose(out[0][k].numpy(), out[1][k].numpy(), atol=2e-5, err_msg=k)


def test_indivisible_microbatches_raise():
    cfg = _configs("smollm-135m", num_microbatches=3)[1]
    _, jparams, jopt = _jax_state("smollm-135m")
    model, params, opt = _port_state(jparams, jopt, cfg)
    with pytest.raises(ValueError, match="not divisible"):
        make_train_step(model, OptimizerConfig())(params, opt,
                                                  {"tokens": torch.zeros((4, 8), dtype=torch.long)})


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_chunk_matches_unchunked_and_jax(arch):
    """loss_chunk=8 at S=20 (two chunks and a remainder): the port's chunked
    loss equals its unchunked one (rel 1e-5, the reference's test) and
    JAX's chunked loss; its gradients equal the unchunked ones within atol
    2e-6 (measured at most 1.2e-6, falcon-mamba's untied head summed over
    chunks in another order, gradients up to 3)."""
    jcfg, cfg = _configs(arch, loss_chunk=8)
    _, cfg0 = _configs(arch)
    jparams = JaxLM(jcfg).init(jax.random.key(0))
    toks = _batches(cfg, 1, B=2, S=20)[0]
    want, _ = JaxLM(jcfg).loss(jparams, {"tokens": jnp.asarray(toks)})
    tparams = convert.lm_params_from_jax(_np(jparams), cfg)
    losses, grads = [], []
    for c in (cfg, cfg0):
        model = LM(c, "cpu", params=tparams)
        params = [p.requires_grad_() for p in model.parameters()]
        loss, _ = model.loss({"tokens": torch.from_numpy(toks)})
        losses.append(float(loss.detach()))
        grads.append(torch.autograd.grad(loss, params))
    assert losses[0] == pytest.approx(losses[1], rel=REL)
    assert losses[0] == pytest.approx(float(want), rel=REL)
    for a, b in zip(*grads):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=0, atol=2e-6)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_no_number(arch):
    """cfg.remat recomputes each layer in the backward: loss and gradients
    equal those without it, bitwise."""
    jcfg, cfg = _configs(arch)
    tparams = convert.lm_params_from_jax(_np(JaxLM(jcfg).init(jax.random.key(1))), cfg)
    toks = torch.from_numpy(_batches(cfg, 1)[0])
    out = []
    for remat in (False, True):
        model = LM(dataclasses.replace(cfg, remat=remat), "cpu", params=tparams)
        params = [p.requires_grad_() for p in model.parameters()]
        loss, _ = model.loss({"tokens": toks})
        out.append((loss.detach(), torch.autograd.grad(loss, params)))
    assert torch.equal(out[0][0], out[1][0])
    for a, b in zip(out[0][1], out[1][1]):
        assert torch.equal(a, b)




@pytest.mark.parametrize("codec", ["int8", "topk"])
@pytest.mark.parametrize("arch", ARCHS)
def test_codec_update_matches_jax(arch, codec):
    """The JAX package's ``compress_grads`` + ``adamw_update`` and the port's
    on the same (JAX) gradients, 3 steps with error-feedback residuals
    carried: compressed update, residuals, moments, master weights and the
    metrics agree."""
    cfg = _configs(arch)[1]
    jcomp, comp = JComp(codec=codec), CompressionConfig(codec=codec)
    jmodel, jparams, jopt = _jax_state(arch, codec)
    model, params, opt = _port_state(jparams, jopt, cfg, comp)
    j_grads = jax.jit(lambda p, t: jax.grad(lambda q: jmodel.loss(q, {"tokens": t})[0])(p))
    assert "residuals" in opt and "residuals" in jopt

    @jax.jit
    def j_update(grads, opt_state, params):
        g, res, stats = j_compress_grads(grads, opt_state["residuals"], jcomp)
        core = {k: v for k, v in opt_state.items() if k != "residuals"}
        new_params, new_opt, ostats = j_adamw_update(g, core, params, JOpt(**OPT))
        new_opt["residuals"] = res
        return new_params, new_opt, {**stats, **ostats}

    for s, toks in enumerate(_batches(cfg)):
        grads = j_grads(jparams, jnp.asarray(toks))
        jparams, jopt, jstats = j_update(grads, jopt, jparams)
        g, res, stats = compress_grads(_named(grads, cfg), opt["residuals"], comp,
                                       model.stacked_groups())
        core = {k: v for k, v in opt.items() if k != "residuals"}
        new_params, opt, ostats = adamw_update(g, core, params, OptimizerConfig(**OPT))
        opt["residuals"] = res
        params = new_params
        for key in ("compression_err_norm", "grad_norm", "lr"):
            np.testing.assert_allclose(float({**stats, **ostats}[key]), float(jstats[key]),
                                       rtol=REL, err_msg=f"{arch} {codec} step {s} {key}")
    _assert_state(params, opt, jparams, jopt, cfg)


@pytest.mark.parametrize("codec", ["int8", "topk"])
def test_codec_train_step_is_the_chain(codec):
    """The port's train step with a codec = its loss gradient, then
    ``compress_grads`` with the state's residuals, then ``adamw_update``,
    the new residuals kept in the state: equal, bitwise, over 3 steps."""
    cfg = _configs("smollm-135m")[1]
    comp = CompressionConfig(codec=codec)
    _, jparams, jopt = _jax_state("smollm-135m", codec)
    model, params, opt = _port_state(jparams, jopt, cfg, comp)
    twin, tparams, topt = _port_state(jparams, jopt, cfg, comp)
    step = make_train_step(model, OptimizerConfig(**OPT), comp)
    for toks in _batches(cfg):
        params, opt, m = step(params, opt, {"tokens": torch.from_numpy(toks)})
        loss, _ = twin.loss({"tokens": torch.from_numpy(toks)})
        grads = dict(zip(tparams, torch.autograd.grad(loss, list(tparams.values()))))
        g, res, stats = compress_grads(grads, topt["residuals"], comp, twin.stacked_groups())
        core = {k: v for k, v in topt.items() if k != "residuals"}
        new_params, topt, _ = adamw_update(g, core, tparams, OptimizerConfig(**OPT))
        topt["residuals"] = res
        with torch.no_grad():
            for k, p in tparams.items():
                p.copy_(new_params[k])
        assert torch.equal(m["loss"], loss.detach())
        assert torch.equal(m["compression_err_norm"], stats["compression_err_norm"])
    for k in params:
        assert torch.equal(params[k], tparams[k])
        for key in ("m", "v", "master", "residuals"):
            assert torch.equal(opt[key][k], topt[key][k]), (key, k)


def test_compression_codecs_match_jax_on_the_same_gradients():
    """int8 (round half to even, ties included) and top-k on the same
    numbers: outputs equal JAX's, run under ``jit`` as its train step runs
    them, and residuals within one ulp of the largest entry (under ``jit``
    XLA fuses the int8 residual ``g - q * scale`` into one FMA)."""
    rng = np.random.default_rng(3)
    g = {"a": rng.normal(size=(40, 7)).astype(np.float32),
         "b": (np.arange(-8, 9, dtype=np.float32) * 0.5),       # exact .5 ties on the grid
         "c": rng.normal(size=(300,)).astype(np.float32)}
    r = {k: (0.01 * rng.normal(size=v.shape)).astype(np.float32) for k, v in g.items()}
    for codec in ("int8", "topk"):
        for ef in (True, False):
            jcomp = JComp(codec=codec, topk_frac=0.05, error_feedback=ef)
            jout, jres, jst = jax.jit(lambda a, b: j_compress_grads(a, b, jcomp))(
                {k: jnp.asarray(v) for k, v in g.items()}, {k: jnp.asarray(v) for k, v in r.items()})
            out, res, st = compress_grads(
                {k: torch.from_numpy(v) for k, v in g.items()},
                {k: torch.from_numpy(v) for k, v in r.items()},
                CompressionConfig(codec=codec, topk_frac=0.05, error_feedback=ef))
            for k in g:
                np.testing.assert_array_equal(out[k].numpy(), np.asarray(jout[k]), err_msg=k)
                ulp = float(np.spacing(np.abs(g[k] + (r[k] if ef else 0)).max()))
                np.testing.assert_allclose(res[k].numpy(), np.asarray(jres[k]), rtol=0, atol=ulp,
                                           err_msg=k)
            assert float(st["compression_err_norm"]) == pytest.approx(
                float(jst["compression_err_norm"]), rel=1e-6)
    # a JAX leaf stacked over 3 repeats is one codec group of 3 port tensors
    stacked = rng.normal(size=(3, 6, 5)).astype(np.float32)
    stacked[2] *= 20.0                                   # one layer sets the int8 scale
    for codec in ("int8", "topk"):
        jcomp = JComp(codec=codec, topk_frac=0.1)
        jout, _, _ = jax.jit(lambda a: j_compress_grads(a, None, jcomp))({"w": jnp.asarray(stacked)})
        out, _, _ = compress_grads({f"l{i}": torch.from_numpy(stacked[i]) for i in range(3)},
                                   None, CompressionConfig(codec=codec, topk_frac=0.1),
                                   groups=[["l0", "l1", "l2"]])
        for i in range(3):
            np.testing.assert_array_equal(out[f"l{i}"].numpy(), np.asarray(jout["w"][i]))
    with pytest.raises(ValueError, match="exactly once"):
        compress_grads({"a": torch.ones(2)}, None, CompressionConfig(codec="int8"), groups=[])
    same, _, stats = compress_grads({"a": torch.ones(2)}, None, CompressionConfig())
    assert torch.equal(same["a"], torch.ones(2)) and stats == {}


@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_lr_at_matches_jax(schedule):
    cfg = dict(lr=3e-3, warmup_steps=10, total_steps=100, schedule=schedule)
    steps = np.arange(0, 130, dtype=np.int32)
    want = np.asarray(jax.vmap(lambda s: j_lr_at(JOpt(**cfg), s))(jnp.asarray(steps)))
    got = np.array([float(lr_at(OptimizerConfig(**cfg), torch.tensor(int(s), dtype=torch.int32)))
                    for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    assert got.dtype == np.float64 and lr_at(OptimizerConfig(**cfg), 5).dtype == torch.float32


def test_global_norm_matches_jax():
    rng = np.random.default_rng(0)
    tree = {f"t{i}": rng.normal(size=shape).astype(np.float32)
            for i, shape in enumerate([(3, 4), (17,), (2, 5, 6), ()])}
    want = float(j_global_norm({k: jnp.asarray(v) for k, v in tree.items()}))
    got = global_norm({k: torch.from_numpy(np.asarray(v)) for k, v in tree.items()})
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=1e-6)
    bf = global_norm({"x": torch.full((4,), 0.5, dtype=torch.bfloat16)})
    assert float(bf) == 1.0


def test_serving_model_is_frozen_and_the_trainer_unfreezes_it():
    cfg = configs.get_smoke_config("smollm-135m")
    model = LM(cfg, "cpu", seed=0)
    assert not any(p.requires_grad for p in model.parameters())
    params, opt = init_train_state(model)
    assert list(params) == [n for n, _ in model.named_parameters()]
    assert all(p.requires_grad for p in model.parameters())
    assert set(opt) == {"m", "v", "master", "step"} and opt["step"].dtype == torch.int32
    _, opt = init_train_state(model, CompressionConfig(codec="int8"))
    assert set(opt["residuals"]) == set(params)


def test_train_state_from_jax_names_and_layout():
    cfg = _configs("recurrentgemma-9b")[1]
    _, jparams, jopt = _jax_state("recurrentgemma-9b", "topk")
    tparams, topt = convert.train_state_from_jax(_np(jparams), _np(jopt), cfg)
    model = LM(cfg, "cpu", params=tparams)
    names = [n for n, _ in model.named_parameters()]
    assert list(named_params(tparams)) == names
    for key in ("m", "v", "master", "residuals"):
        assert list(topt[key]) == names
        assert all(topt[key][n].shape == p.shape for n, p in model.named_parameters())
    for n, p in model.named_parameters():
        assert torch.equal(topt["master"][n], p.float())


def test_loss_branches_not_ported_raise():
    """The loss's frontend branch, which raised until the frontend families
    were ported, now runs as JAX's does (rel 1e-5): frontend embeddings on
    a config without a frontend are prepended all the same, and a frontend
    config given tokens alone takes the tokens' own targets. Embeddings of
    the wrong width still raise. (The name is kept from when the branch
    raised.)"""
    jcfg, cfg = _configs("smollm-135m")
    jparams = JaxLM(jcfg).init(jax.random.key(0))
    model = LM(cfg, "cpu", params=convert.lm_params_from_jax(_np(jparams), cfg))
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    fe = rng.normal(0, 1, (2, 3, cfg.d_model)).astype(np.float32)
    for c, model_c, batch in (
            (jcfg, model, {"tokens": toks, "frontend_embeds": fe}),
            (dataclasses.replace(jcfg, frontend="vision", frontend_len=3),
             LM(dataclasses.replace(cfg, frontend="vision", frontend_len=3), "cpu",
                params=convert.lm_params_from_jax(_np(jparams), cfg)), {"tokens": toks})):
        want, wm = JaxLM(c).loss(jparams, {k: jnp.asarray(v) for k, v in batch.items()})
        got, m = model_c.loss({k: torch.from_numpy(v) for k, v in batch.items()})
        assert float(got) == pytest.approx(float(want), rel=REL)
        assert float(m["nll"]) == float(got) and float(m["aux"]) == 0.0
    with pytest.raises(RuntimeError):
        model.loss({"tokens": torch.from_numpy(toks),
                    "frontend_embeds": torch.zeros((2, 3, cfg.d_model + 1))})


def test_softcap_grad_and_no_grad_agree():
    """The logit softcap runs out of place under grad (autograd needs its
    input) and in place without: the same logits."""
    cfg = configs.get_smoke_config("recurrentgemma-9b")
    model = LM(cfg, "cpu", seed=0)
    h = torch.randn(2, 5, cfg.d_model)
    with torch.no_grad():
        a = model.logits(h)
    b = model.logits(h.requires_grad_())
    assert b.requires_grad and torch.equal(a, b.detach())
