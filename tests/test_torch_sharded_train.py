"""The port's sharded train step on four gloo ranks, a ``(data=2,
model=2)`` ``DeviceMesh``, against the JAX package's single-device step
and against the port's own unsharded step.

* JAX's own case (``tests/test_distributed.py::test_pjit_train_step_matches_single_device``
  on the port at 2x2): smollm-135m SMOKE, one microbatch, batch 8 x 16,
  lr 1e-3, one step from JAX's ``init_train_state`` weights: the loss
  within rel 1e-5 and every parameter within 5e-5 of JAX's jitted
  single-device step, that test's bounds.
* Sharded against unsharded, two steps each from the same weights
  (``LM(cfg, seed=0)``), the same bounds on the loss and ``grad_norm`` at
  each step and on the parameters, moments, master weights and residuals
  after them: recurrentgemma-9b, falcon-mamba-7b, granite-moe-1b-a400m and
  internvl2-2b SMOKE (one microbatch each, as their SMOKE configs have),
  granite also at two microbatches, smollm-135m with the int8 and the topk
  codecs and with remat. Granite runs at capacity factor 0.5, where the
  unsharded step drops tokens: the drops are asserted, and the sharded
  aux loss at the first weights equals the unsharded one (rel 1e-6).
  Measured on a CPU (gloo ranks): losses within rel 1.6e-7, parameters within
  5.2e-6.
* Every rank's local shapes of the parameters, moments, master weights and
  residuals equal ``Sharding.shard_shape`` of ``param_specs``, leaf by
  leaf; every rank reports the same metrics.
* Each kernel wrapper, and ``KernelFunction``, refuses a ``DTensor``.
* ``placements`` of a spec, ``batch_block`` and ``make_debug_mesh``
  without a world.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):      # removed in jax 0.9
    jax.experimental.enable_x64 = jax.enable_x64

import dataclasses
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ep as ep
import _torch_sharded as sh
from repro import configs as jconfigs
from repro.models import LM as JaxLM
from repro.training import OptimizerConfig as JOpt
from repro.training import init_train_state as j_init_train_state
from repro.training import make_train_step as j_make_train_step
from repro_torch import configs, convert
from repro_torch.distributed import AxisRules, Mesh, param_specs, use_rules
from repro_torch.distributed.sharding import batch_block, placements
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import LM, blocks, named_params
from repro_torch.models.moe import capacity_for, router_topk
from repro_torch.training import (CompressionConfig, OptimizerConfig, init_train_state,
                                  make_train_step)
from _torch_serving import one_torch_thread  # noqa: F401  (autouse: torch on one CPU thread)

REL = 1e-5                   # tests/test_distributed.py:113
PARAM_ATOL = 5e-5            # tests/test_distributed.py:114
AUX_REL = 1e-6
OPT = dict(lr=1e-3, warmup_steps=1)
GRANITE_CAPACITY = 0.5
# name -> (arch, config changes, codec)
CASES = {
    "recurrentgemma-9b": ("recurrentgemma-9b", {}, "none"),
    "falcon-mamba-7b": ("falcon-mamba-7b", {}, "none"),
    "granite-moe-1b-a400m": ("granite-moe-1b-a400m",
                             {"expert_capacity_factor": GRANITE_CAPACITY}, "none"),
    "granite-moe-1b-a400m-m2": ("granite-moe-1b-a400m",
                                {"expert_capacity_factor": GRANITE_CAPACITY,
                                 "num_microbatches": 2}, "none"),
    "internvl2-2b": ("internvl2-2b", {}, "none"),
    "smollm-135m-int8": ("smollm-135m", {}, "int8"),
    "smollm-135m-topk": ("smollm-135m", {}, "topk"),
    "smollm-135m-remat": ("smollm-135m", {"remat": True}, "none"),
}
STEPS = 2
B, S = 8, 16


def _batches(cfg, n=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64)}
        if cfg.frontend != "none":
            b["frontend_embeds"] = rng.normal(0, 1, (B, cfg.frontend_len, cfg.d_model)
                                              ).astype(np.float32)
        out.append(b)
    return out


def _jax_case():
    """smollm-135m as tests/test_distributed.py sets it up: JAX's initial
    weights, its batch, and JAX's jitted single-device step's results."""
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("smollm-135m"), num_microbatches=1)
    jmodel = JaxLM(jcfg)
    jparams, jopt = j_init_train_state(jmodel, jax.random.key(0))
    tokens = np.random.default_rng(0).integers(0, jcfg.vocab_size, (B, S)).astype(np.int32)
    p1, _, m1 = jax.jit(j_make_train_step(jmodel, JOpt(lr=1e-3)))(
        jparams, jopt, {"tokens": jnp.asarray(tokens)})
    cfg = configs.get_smoke_config("smollm-135m")
    to_np = lambda tree: jax.tree.map(np.asarray, tree)
    case = {"name": "jax", "arch": "smollm-135m", "changes": {"num_microbatches": 1},
            "codec": "none", "opt": {"lr": 1e-3}, "batches": [{"tokens": tokens}],
            "params": convert.lm_params_from_jax(to_np(jparams), cfg)}
    want = {"loss": float(m1["loss"]),
            "params": named_params(convert.lm_params_from_jax(to_np(p1), cfg))}
    return case, want


def _unsharded(case):
    """The port's unsharded step on the case's batches, from ``seed=0``
    weights: metrics, the first loss's metrics, the state after the steps."""
    cfg = sh._cfg(case["arch"], case["changes"])
    comp = CompressionConfig(codec=case["codec"])
    model = LM(cfg, device="cpu", seed=0)
    params, opt = init_train_state(model, comp)
    with torch.no_grad():
        loss, met = model.loss(sh._batch(case["batches"][0]))
    step = make_train_step(model, OptimizerConfig(**case["opt"]), comp)
    metrics = []
    for b in case["batches"]:
        params, opt, m = step(params, opt, sh._batch(b))
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "first": {"aux": float(met["aux"]), "loss": float(loss)},
            "state": {"params": {k: p.detach() for k, p in params.items()}, "opt": opt}}


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The four ranks over every case; JAX's results; the unsharded runs."""
    jcase, jwant = _jax_case()
    cases = [jcase]
    for name, (arch, changes, codec) in CASES.items():
        cfg = sh._cfg(arch, changes)
        cases.append({"name": name, "arch": arch, "changes": changes, "codec": codec,
                      "opt": OPT, "batches": _batches(cfg)})
    ranks = ep.run_world(str(tmp_path_factory.mktemp("sharded")), {"cases": cases},
                         work=sh.train_world)
    return types.SimpleNamespace(
        ranks=ranks, cases={c["name"]: c for c in cases}, jax=jwant,
        root=next(r for r in ranks if r["coords"] == (0, 0)),
        unsharded={c["name"]: _unsharded(c) for c in cases[1:]})


def test_mesh_coordinates(world):
    assert sorted(r["coords"] for r in world.ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_sharded_step_matches_jax_single_device(world):
    got = world.root["cases"]["jax"]
    assert got["metrics"][0]["loss"] == pytest.approx(world.jax["loss"], rel=REL)
    params = got["state"]["params"]
    assert params.keys() == world.jax["params"].keys()
    diff = max(float((params[k] - t).abs().max()) for k, t in world.jax["params"].items())
    assert diff < PARAM_ATOL


@pytest.mark.parametrize("name", list(CASES))
def test_sharded_step_matches_unsharded(world, name):
    got, want = world.root["cases"][name], world.unsharded[name]
    assert len(got["metrics"]) == len(want["metrics"]) == STEPS
    for s, (a, b) in enumerate(zip(got["metrics"], want["metrics"])):
        assert a.keys() == b.keys()
        for key in ("loss", "grad_norm", "lr") + (("compression_err_norm",) if
                                                  "compression_err_norm" in b else ()):
            assert a[key] == pytest.approx(b[key], rel=REL), f"step {s} {key}"
    for key in ("m", "v", "master") + (("residuals",) if "residuals" in want["state"]["opt"]
                                       else ()):
        assert got["state"]["opt"][key].keys() == want["state"]["opt"][key].keys()
        for k, t in want["state"]["opt"][key].items():
            np.testing.assert_allclose(got["state"]["opt"][key][k].numpy(), t.numpy(), rtol=0,
                                       atol=PARAM_ATOL, err_msg=f"{key} {k}")
    assert int(got["state"]["opt"]["step"]) == int(want["state"]["opt"]["step"]) == STEPS
    for k, t in want["state"]["params"].items():
        np.testing.assert_allclose(got["state"]["params"][k].numpy(), t.numpy(), rtol=0,
                                   atol=PARAM_ATOL, err_msg=k)


def _drops(case) -> int:
    """Pairs the unsharded step's first MoE layer drops on the first batch."""
    cfg = sh._cfg(case["arch"], case["changes"])
    seen = []
    dense = blocks.moe_mlp
    blocks.moe_mlp = lambda x, rw, *a: seen.append((x, rw)) or dense(x, rw, *a)
    try:
        with torch.no_grad():
            LM(cfg, device="cpu", seed=0).loss(sh._batch(case["batches"][0]))
    finally:
        blocks.moe_mlp = dense
    x, rw = seen[0]
    idx, _ = router_topk(x.float() @ rw.float(), cfg.experts_per_token)
    counts = torch.bincount(idx.reshape(-1), minlength=cfg.num_experts)
    C = capacity_for(x.shape[0], cfg.num_experts, cfg.experts_per_token,
                     cfg.expert_capacity_factor)
    return int((counts - C).clamp(min=0).sum())


@pytest.mark.parametrize("name", ["granite-moe-1b-a400m", "granite-moe-1b-a400m-m2"])
def test_granite_drops_tokens_and_aux_matches(world, name):
    assert _drops(world.cases[name]) > 0
    got, want = world.root["cases"][name]["first"], world.unsharded[name]["first"]
    assert want["aux"] > 0
    assert got["aux"] == pytest.approx(want["aux"], rel=AUX_REL)
    assert got["loss"] == pytest.approx(want["loss"], rel=REL)


@pytest.mark.parametrize("name", ["jax", *CASES])
def test_state_layout_matches_param_specs(world, name):
    case = world.cases[name]
    model = LM(sh._cfg(case["arch"], case["changes"]), device="meta")
    named = dict(model.named_parameters())
    specs = param_specs(named, AxisRules(make_debug_mesh(2, 2)))
    want = {k: specs[k].shard_shape(p.shape) for k, p in named.items()}
    assert any(want[k] != tuple(p.shape) for k, p in named.items())     # something shards
    for r in world.ranks:
        shapes = r["cases"][name]["shapes"]
        keys = ["params", "m", "v", "master"] + (["residuals"] if case["codec"] != "none" else [])
        assert sorted(k for k in shapes if k != "step") == sorted(keys)
        for key in keys:
            assert shapes[key] == want, f"rank {r['coords']} {key}"
        assert shapes["step"] == ()


def test_every_rank_reports_the_same_metrics(world):
    for name in world.cases:
        first = world.root["cases"][name]
        for r in world.ranks:
            assert r["cases"][name]["metrics"] == first["metrics"], (name, r["coords"])
            assert r["cases"][name]["first"] == first["first"], (name, r["coords"])


@pytest.mark.parametrize("name", ["flash_attention", "rglru_scan", "mamba_scan",
                                  "causal_conv1d", "belief_aggregate", "KernelFunction"])
def test_kernel_wrappers_refuse_a_dtensor(world, name):
    for r in world.ranks:
        assert r["guard"][name] is not None and "DTensor" in r["guard"][name]


class _Names:
    """The part of a ``DeviceMesh`` that ``placements`` reads."""
    def __init__(self, *names):
        self.mesh_dim_names = names


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    mesh = _Names("pod", "data", "model")
    assert placements((None, "model"), mesh) == (Replicate(), Replicate(), Shard(1))
    assert placements(("data", None), mesh) == (Replicate(), Shard(0), Replicate())
    assert placements((("pod", "data"), "model"), mesh) == (Shard(0), Shard(0), Shard(1))
    assert placements((), mesh) == (Replicate(),) * 3
    with pytest.raises(ValueError, match="dim order"):
        placements((("model", "data"),), mesh)


def test_batch_block_without_a_device_mesh_is_the_batch():
    batch = {"tokens": torch.arange(24).reshape(8, 3)}
    assert batch_block(batch, 2) is batch
    with use_rules(AxisRules(make_debug_mesh(2, 2))):          # a layout: nothing split
        assert batch_block(batch, 2) is batch


def test_debug_mesh_is_a_layout_without_a_device_type():
    mesh = make_debug_mesh(2, 4)
    assert isinstance(mesh, Mesh) and mesh.shape == {"data": 2, "model": 4}
