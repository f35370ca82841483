"""The port's expert-parallel MoE against the JAX package's
(``repro/models/moe.py``: ``_rank_within``, ``moe_mlp_ep``) and against
its own dense dispatch.

* ``_rank_within`` equals JAX's on random groups.
* ``moe_mlp_ep`` on four spawned gloo ranks as a ``(data=2, model=2)``
  ``DeviceMesh`` (E=8, T=64, D=32, F=48, k=2, capacity factor 16:
  ``tests/test_perf_features.py``'s sizes, no drops on either path): each
  rank's output is within 1e-4 of the port's dense ``moe_mlp`` on its
  batch shard, and within 1e-5 (output) and 1e-6 (``aux``) of JAX's
  ``moe_mlp_ep`` on a ``(2, 2)`` mesh of forced host devices in a
  subprocess (as ``tests/test_perf_features.py::_EP_SCRIPT`` runs it);
  its input gradient (``sum(y * y)``, through both all-to-alls) is within
  1e-4 of the dense path's.
* A granite-moe SMOKE forward under ``cfg.moe_ep`` (capacity 16) over that
  mesh equals the dense forward on each rank's batch shard; under a
  layout-only mesh ``cfg.moe_ep`` raises.
* ``local_experts`` takes only a full (E, ...) weight, and ``moe_mlp_ep``
  refuses an expert weight whose leading dim is not this rank's share.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):      # removed in jax 0.9
    jax.experimental.enable_x64 = jax.enable_x64

import dataclasses
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_ep as ep
from repro.models import moe as jmoe
from repro_torch import configs
from repro_torch.distributed import AxisRules, use_rules
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import LM
from repro_torch.models.moe import _rank_within, local_experts, moe_mlp, moe_mlp_ep

ROOT = Path(__file__).resolve().parents[1]

_JAX_EP_SCRIPT = textwrap.dedent(
    """
    import os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.models.moe import moe_mlp_ep

    inp = np.load(sys.argv[1])
    mesh = jax.make_mesh((2, 2), ("data", "model"))
    args = [jnp.asarray(inp[k]) for k in ("x", "rw", "wg", "wu", "wd")]
    with mesh:
        y, aux = jax.jit(lambda *a: moe_mlp_ep(*a, k=%d, capacity_factor=%r, mesh=mesh,
                                                batch_axes=("data",), expert_axis="model"))(*args)
    np.savez(sys.argv[2], y=np.asarray(y), aux=np.asarray(aux))
    """ % (ep.K, ep.CAPACITY)
)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The port's four ranks, then JAX's EP on the same inputs."""
    tmp = tmp_path_factory.mktemp("moe_ep")
    inputs = ep.moe_inputs()
    cfg = configs.get_smoke_config("granite-moe-1b-a400m")
    ranks = ep.run_world(str(tmp), {**inputs, "tokens": ep.granite_tokens(cfg.vocab_size)})
    np.savez(tmp / "in.npz", **inputs)
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "JAX_PLATFORMS": "cpu"}
    out = subprocess.run([sys.executable, "-c", _JAX_EP_SCRIPT, str(tmp / "in.npz"),
                          str(tmp / "jax.npz")], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return inputs, ranks, dict(np.load(tmp / "jax.npz"))


def _shard(a, d: int):
    t_l = a.shape[0] // ep.MESH[0]
    return a[d * t_l:(d + 1) * t_l]


def _dense(inputs):
    """The port's dense dispatch on all T tokens: output, aux, input gradient."""
    w = {k: torch.from_numpy(v) for k, v in inputs.items()}
    x = w["x"].clone().requires_grad_()
    y, aux = moe_mlp(x, w["rw"], w["wg"], w["wu"], w["wd"], ep.K, ep.CAPACITY)
    (y * y).sum().backward()
    return y.detach(), aux.detach(), x.grad


@pytest.mark.parametrize("n,groups", [(1, 1), (17, 3), (128, 8), (400, 5), (64, 64)])
def test_rank_within_matches_jax(n, groups):
    g = np.random.default_rng(n * 31 + groups).integers(0, groups, n)
    want = np.asarray(jmoe._rank_within(jnp.asarray(g, jnp.int32), groups))
    got = _rank_within(torch.as_tensor(g), groups).numpy()
    np.testing.assert_array_equal(got, want)


def test_mesh_coordinates(runs):
    _, ranks, _ = runs
    assert sorted((r["data"], r["model"]) for r in ranks) == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_ep_matches_dense(runs):
    inputs, ranks, _ = runs
    y, _, _ = _dense(inputs)
    for r in ranks:
        np.testing.assert_allclose(r["y"].numpy(), _shard(y.numpy(), r["data"]), atol=1e-4, rtol=0)


def test_ep_matches_jax_ep(runs):
    _, ranks, jax_out = runs
    for r in ranks:
        np.testing.assert_allclose(r["y"].numpy(), _shard(jax_out["y"], r["data"]),
                                   atol=1e-5, rtol=0)
        assert abs(float(r["aux"]) - float(jax_out["aux"])) <= 1e-6


def test_ep_input_gradient_matches_dense(runs):
    inputs, ranks, _ = runs
    _, _, grad = _dense(inputs)
    for r in ranks:
        assert r["grad"] is not None
        np.testing.assert_allclose(r["grad"].numpy(), _shard(grad.numpy(), r["data"]),
                                   atol=1e-4, rtol=0)


def test_granite_forward_under_moe_ep(runs):
    _, ranks, _ = runs
    cfg = dataclasses.replace(configs.get_smoke_config("granite-moe-1b-a400m"),
                              expert_capacity_factor=ep.CAPACITY)
    tokens = torch.from_numpy(ep.granite_tokens(cfg.vocab_size))
    with torch.no_grad():
        dense = LM(cfg, device="cpu", seed=0)(tokens)
    for r in ranks:
        assert r["ep_calls"] == cfg.layer_types.count("moe") > 0    # every MoE layer went EP
        np.testing.assert_allclose(r["logits"].numpy(), _shard(dense.numpy(), r["data"]),
                                   atol=1e-4, rtol=1e-4)


def test_moe_ep_needs_a_device_mesh():
    cfg = dataclasses.replace(configs.get_smoke_config("granite-moe-1b-a400m"), moe_ep=True)
    model = LM(cfg, device="cpu", seed=0)
    tokens = torch.zeros((2, 8), dtype=torch.long)
    with torch.no_grad():
        model(tokens)                                   # no rules: the dense path
        with use_rules(AxisRules(make_debug_mesh(1, 2))):
            with pytest.raises(ValueError, match="DeviceMesh"):
                model(tokens)


class _TwoShardMesh:
    """The part of a ``DeviceMesh`` that the expert weights' checks read:
    a ``model`` axis of two ranks, this one at coordinate 1."""
    mesh_dim_names = ("model",)

    def get_group(self, name):
        return None

    def size(self, dim):
        return 2

    def get_local_rank(self, name):
        return 1


def test_expert_weights_must_be_whole_or_a_shard():
    w = {k: torch.from_numpy(v) for k, v in ep.moe_inputs().items()}
    mesh = _TwoShardMesh()
    torch.testing.assert_close(local_experts(w["wg"], ep.E, mesh), w["wg"][ep.E // 2:])
    assert local_experts(None, ep.E, mesh) is None
    with pytest.raises(ValueError, match="want all"):
        local_experts(w["wg"][: ep.E // 2], ep.E, mesh)
    half = [local_experts(w[n], ep.E, mesh) for n in ("wg", "wu", "wd")]
    for i in range(3):
        bad = list(half)
        bad[i] = w[("wg", "wu", "wd")[i]]
        with pytest.raises(ValueError, match="a shard 4"):
            moe_mlp_ep(w["x"], w["rw"], *bad, ep.K, ep.CAPACITY, mesh)
