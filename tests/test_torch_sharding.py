"""The port's sharding rules against the JAX package's
(``repro/distributed/sharding.py``).

* ``tests/test_distributed.py::TestAxisRules``'s four cases, on the port.
* Leaf-by-leaf parity at the production layouts: for all ten archs at
  published width, on ``16x16`` and ``2x16x16`` layouts, with the default
  rules and with ``{"zero3": True}``, every parameter and optimizer leaf's
  spec and shard shape, every ``decode_32k`` and (where it applies)
  ``long_500k`` cache leaf's, and the ``train_4k`` and ``prefill_32k``
  batch leaves'. The JAX side runs on ``jax.sharding.AbstractMesh`` (no
  devices) over ``jax.eval_shape`` trees; a port leaf's spec is the JAX
  stacked leaf's without its leading stacked dim (trailing ``None``
  entries are not significant in either).
* ``constrain`` is the identity, rules or not; ``constrain_params`` is
  too without rules and under a layout mesh (it pins a tree to
  ``param_specs`` only over a ``DeviceMesh``, ``tests/test_torch_sharded_train.py``).
* ``replica_mesh`` is None on the CPU and on one card, and a
  ``("replica",)`` mesh over ``min(R, n)`` cards with a patched count.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):      # removed in jax 0.9
    jax.experimental.enable_x64 = jax.enable_x64

import functools
import types

import jax.numpy as jnp
import pytest
import torch
from jax.sharding import AbstractMesh, NamedSharding

from _torch_layout import at, cache_path, param_path
from repro import configs as jconfigs
from repro.distributed import sharding as jsharding
from repro.launch import specs as jspecs
from repro.models import SHAPES as JSHAPES
from repro.models import shape_applicable as jshape_applicable
from repro_torch import configs
from repro_torch.distributed import (
    AxisRules,
    Mesh,
    Sharding,
    batch_specs,
    cache_specs,
    constrain,
    constrain_params,
    param_specs,
    replica_mesh,
    use_rules,
)
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import specs as tspecs
from repro_torch.models import SHAPES
from repro_torch.models.model import named_params

ARCHS = configs.list_archs()
LAYOUTS = {"16x16": ((16, 16), ("data", "model")),
           "2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
RULES = {"default": {}, "zero3": {"zero3": True}}


def _rules(shape: dict) -> AxisRules:
    return AxisRules(Mesh(tuple(shape), tuple(shape.values())))


class TestAxisRules:
    def test_divisibility_fallback(self):
        r = _rules({"data": 16, "model": 16})
        # 36 heads: tp dropped; flat 4608 feature dim: tp kept
        assert r.spec_for((4608, 4608), ("fsdp", "tp"))[1] == "model"
        assert r.spec_for((100, 36), (None, "heads"))[1] is None

    def test_no_axis_reuse(self):
        r = _rules({"data": 16, "model": 16})
        spec = r.spec_for((32, 32768, 16, 128), ("batch", "kv", "heads", None))
        # kv grabs 'model'; heads must not reuse it
        assert spec[1] == "model" and spec[2] is None

    def test_batch_maps_to_pod_and_data(self):
        r = _rules({"pod": 2, "data": 16, "model": 16})
        spec = r.spec_for((256, 4096), ("batch", None))
        assert tuple(spec[0]) == ("pod", "data")

    def test_batch_of_one_replicates(self):
        r = _rules({"data": 16, "model": 16})
        assert r.spec_for((1, 8), ("batch", None))[0] is None


def test_rules_read_a_device_mesh_by_name():
    """A ``DeviceMesh`` has ``.shape`` as a tuple and its names in
    ``.mesh_dim_names``; the rules read it as the port's mesh."""
    dm = types.SimpleNamespace(shape=(2, 4), mesh_dim_names=("data", "model"))
    r = AxisRules(dm)
    assert r.sizes == {"data": 2, "model": 4}
    assert r.spec_for((8, 12), ("batch", "tp")) == ("data", "model")
    assert Sharding(dm, ("data", "model")).shard_shape((8, 12)) == (4, 3)
    with pytest.raises(ValueError, match="mesh_dim_names"):
        AxisRules(types.SimpleNamespace(shape=(2, 4), mesh_dim_names=None))


def test_production_layouts():
    assert tmesh.make_production_mesh().shape == {"data": 16, "model": 16}
    multi = tmesh.make_production_mesh(multi_pod=True)
    assert multi.shape == {"pod": 2, "data": 16, "model": 16} and multi.size == 512
    assert multi.devices is None
    assert tmesh.make_debug_mesh(2, 4).shape == {"data": 2, "model": 4}


def _norm(spec) -> tuple:
    spec = tuple(spec)
    while spec and spec[-1] is None:
        spec = spec[:-1]
    return spec


@functools.lru_cache(maxsize=None)
def _jax_trees(arch: str):
    jcfg = jconfigs.get_config(arch)
    params = jspecs.param_specs_for(jcfg)
    return params, jspecs.opt_specs_for(params)


@functools.lru_cache(maxsize=None)
def _port_trees(arch: str):
    cfg = configs.get_config(arch)
    params = tspecs.param_specs_for(cfg)
    return params, tspecs.opt_specs_for(params)


def _check_leaf(got: Sharding, shape, jsh: NamedSharding, jshape, row, what: str):
    """The port leaf's spec and shard shape against the JAX leaf's (its
    stacked dim dropped where ``row`` is not None)."""
    jspec, jblock = tuple(jsh.spec), jsh.shard_shape(tuple(jshape))
    if row is not None:
        assert tuple(jshape)[1:] == tuple(shape), what
        assert jspec[:1] in ((), (None,)), what
        jspec, jblock = jspec[1:], jblock[1:]
    else:
        assert tuple(jshape) == tuple(shape), what
    assert _norm(got.spec) == _norm(jspec), (what, got.spec, jspec)
    assert got.shard_shape(shape) == tuple(jblock), what


@pytest.mark.parametrize("rules_name", list(RULES))
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_jax(arch, layout, rules_name):
    sizes, names = LAYOUTS[layout]
    overrides = RULES[rules_name]
    jrules = jsharding.AxisRules(AbstractMesh(sizes, names), dict(overrides))
    rules = AxisRules(Mesh(names, sizes), dict(overrides))
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)

    # parameters and optimizer state
    jparams, jopt = _jax_trees(arch)
    params, opt = _port_trees(arch)
    jp_sh, jo_sh = jsharding.param_specs(jparams, jrules), jsharding.param_specs(jopt, jrules)
    p_sh = named_params(param_specs(params, rules))
    o_sh = param_specs(opt, rules)
    flat = named_params(params)
    assert len(p_sh) == len(flat) > 0
    for name, t in flat.items():
        path, row = param_path(name, cfg)
        _check_leaf(p_sh[name], t.shape, at(jp_sh, path), at(jparams, path).shape, row, name)
        for part in ("m", "v", "master"):
            _check_leaf(o_sh[part][name], t.shape, at(jo_sh, (part, *path)),
                        at(jopt, (part, *path)).shape, row, f"{part}/{name}")
    assert o_sh["step"].spec == () and tuple(jo_sh["step"].spec) == ()

    # decode caches
    n_cache = 0
    for shape_name in ("decode_32k", "long_500k"):
        shape = SHAPES[shape_name]
        if not jshape_applicable(jcfg, JSHAPES[shape_name]):
            continue
        jcache, _ = jspecs.decode_specs_for(jcfg, JSHAPES[shape_name])
        jc_sh = jsharding.cache_specs(jcache, jrules)
        cache, _ = tspecs.decode_specs_for(cfg, shape)
        c_sh = cache_specs(cache, rules)
        if cache["ring"] is not None:
            _check_leaf(c_sh["ring"], cache["ring"].shape, jc_sh["ring"],
                        jcache["ring"].shape, None, "ring")
        for i, layer in enumerate(cache["layers"]):
            for leaf, t in layer.items():
                path, row = cache_path(i, leaf, cfg)
                _check_leaf(c_sh["layers"][i][leaf], t.shape, at(jc_sh, path),
                            at(jcache, path).shape, row, f"{shape_name} layer {i} {leaf}")
                n_cache += 1
    assert n_cache > 0

    # batches
    for shape_name in ("train_4k", "prefill_32k"):
        jbatch = jspecs.batch_specs_for(jcfg, JSHAPES[shape_name])
        batch = tspecs.batch_specs_for(cfg, SHAPES[shape_name])
        jb_sh, b_sh = jsharding.batch_specs(jbatch, jrules), batch_specs(batch, rules)
        assert batch.keys() == jbatch.keys()
        for k, t in batch.items():
            _check_leaf(b_sh[k], t.shape, jb_sh[k], jbatch[k].shape, None, f"{shape_name} {k}")


def test_constrain_is_the_identity():
    x = torch.arange(12.0).reshape(3, 4)
    tree = {"a": x, "b": [x, {"c": x}]}
    rules = _rules({"data": 16, "model": 16})
    for active in (None, rules):
        with use_rules(active):
            assert constrain(x, "batch", "embed") is x
            assert constrain(x, "batch") is x          # rank mismatch too
            assert constrain_params(tree) is tree


def test_replica_mesh(monkeypatch):
    assert replica_mesh(4, "cpu") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert replica_mesh(4, "cuda") is None
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    m = replica_mesh(5, "cuda")
    assert m.axis_names == ("replica",) and m.shape == {"replica": 3}
    assert m.devices == tuple(torch.device("cuda", i) for i in range(3))
    assert replica_mesh(2, "cuda").shape == {"replica": 2}
    assert replica_mesh(1, "cuda") is None
    assert replica_mesh(5, "cpu") is None
