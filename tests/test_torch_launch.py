"""The port's launch tools against the JAX package's
(``repro/launch/specs.py``, ``repro/launch/dryrun.py``), at published
width on the ``meta`` device.

* ``param_specs_for``, ``opt_specs_for``, ``decode_specs_for`` and
  ``batch_specs_for``: every leaf's shape and dtype equal
  ``jax.eval_shape``'s (a port layer leaf is a row of a JAX stacked leaf;
  ``pos`` is a host int in the port), for all ten archs, and every tensor
  is on meta: nothing is allocated.
* ``LM(cfg, device="meta")`` builds for all ten with the JAX parameter
  count; on the CPU, ``LM(cfg, device="cpu", seed=3)`` draws the same
  weights as before the meta branch (a digest of every SMOKE config's
  weights, taken from the port's init before that change: each init
  branch — attention, MoE, SSM, RG-LRU, biases, untied head, GELU).
* The scans' meta branch returns the kernel's shapes and dtypes and
  counts no launch; the other kernels take no meta tensor.
* ``dryrun_cell`` through the CLI (``main``) on every ``decode_32k`` cell
  at ``16x16``, smollm-135m ``train_4k``, falcon-mamba-7b ``prefill_32k``
  (the scans' meta branch) and a skipped ``long_500k``: its analytic
  fields equal the JAX package's roofline functions on the same cell with
  the H100's ``HW``; ``argument_bytes_per_device`` equals the sum over
  JAX's ``param_specs``/``cache_specs``/``batch_specs`` (and the
  optimizer's for training) of ``NamedSharding(AbstractMesh,
  spec).shard_shape`` times the item size, less JAX's 4-byte ``pos``
  (a host int in the port); the JSON record is written under ``--out``.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):      # removed in jax 0.9
    jax.experimental.enable_x64 = jax.enable_x64

import hashlib
import json
import math

import pytest
import torch
from jax.sharding import AbstractMesh

from _torch_layout import at, cache_path, param_path
from repro import configs as jconfigs
from repro.distributed import sharding as jsharding
from repro.launch import roofline as jroof
from repro.launch import specs as jspecs
from repro.models import SHAPES as JSHAPES
from repro_torch import configs
from repro_torch.kernels import ops
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import HW
from repro_torch.models import LM, SHAPES, shape_applicable
from repro_torch.models.model import named_params

ARCHS = configs.list_archs()

# sha256 (first 16 hex digits) of every SMOKE config's weights from
# LM(cfg, device="cpu", seed=3): names, dtypes and bytes in
# named_parameters() order, as the port's init drew them before the meta
# branch was added.
WEIGHT_DIGESTS = {
    "moonshot-v1-16b-a3b": "f732a5bd786d5ee1", "granite-moe-1b-a400m": "4438280b2601c89d",
    "falcon-mamba-7b": "bd828890819bd7e0", "internvl2-2b": "4ffa93a3d4fd1858",
    "h2o-danube-1.8b": "4ffa93a3d4fd1858", "qwen1.5-110b": "ec3c524c7d4b20d2",
    "starcoder2-7b": "c603f3cdb7d348eb", "smollm-135m": "a875172d6fcf6ada",
    "recurrentgemma-9b": "37e1914870a0ba7f", "musicgen-medium": "8d47d37ecd7bff29",
}


def _same(t: torch.Tensor, jleaf, row, what: str) -> None:
    """A port meta tensor has the JAX leaf's shape (a row of it where
    ``row`` is not None) and dtype."""
    jshape = tuple(jleaf.shape)[1:] if row is not None else tuple(jleaf.shape)
    assert t.is_meta, what
    assert tuple(t.shape) == jshape, (what, tuple(t.shape), jshape)
    assert str(t.dtype).removeprefix("torch.") == jleaf.dtype.name, (what, t.dtype, jleaf.dtype)


@pytest.mark.parametrize("arch", ARCHS)
def test_specs_match_jax_eval_shape(arch):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    jparams = jspecs.param_specs_for(jcfg)
    jopt = jspecs.opt_specs_for(jparams)
    params = specs.param_specs_for(cfg)
    opt = specs.opt_specs_for(params)
    flat = named_params(params)
    for name, t in flat.items():
        path, row = param_path(name, cfg)
        _same(t, at(jparams, path), row, name)
        for part in ("m", "v", "master"):
            _same(opt[part][name], at(jopt, (part, *path)), row, f"{part}/{name}")
    assert opt.keys() == jopt.keys()
    assert all(opt[p].keys() == flat.keys() for p in ("m", "v", "master"))
    _same(opt["step"], jopt["step"], None, "step")

    for shape_name in ("decode_32k", "long_500k"):
        shape, jshape = SHAPES[shape_name], JSHAPES[shape_name]
        if not shape_applicable(cfg, shape):
            continue
        jcache, jtok = jspecs.decode_specs_for(jcfg, jshape)
        cache, tok = specs.decode_specs_for(cfg, shape)
        assert cache["pos"] == shape.seq_len - 1 and jcache["pos"].dtype.name == "int32"
        assert (cache["ring"] is None) == (jcache["ring"] is None)
        if cache["ring"] is not None:
            _same(cache["ring"], jcache["ring"], None, "ring")
        assert len(cache["layers"]) == cfg.num_layers
        for i, layer in enumerate(cache["layers"]):
            jleaves = at(jcache, cache_path(i, "k", cfg)[0][:-1])
            assert layer.keys() == jleaves.keys()
            for leaf, t in layer.items():
                path, row = cache_path(i, leaf, cfg)
                _same(t, at(jcache, path), row, f"{shape_name} layer {i} {leaf}")
        _same(tok["tokens"], jtok["tokens"], None, "tokens")
        assert specs.input_specs(cfg, shape).keys() == {"cache", "batch"}

    for shape_name in ("train_4k", "prefill_32k"):
        jbatch = jspecs.batch_specs_for(jcfg, JSHAPES[shape_name])
        batch = specs.batch_specs_for(cfg, SHAPES[shape_name])
        assert batch.keys() == jbatch.keys()
        for k, t in batch.items():
            _same(t, jbatch[k], None, f"{shape_name} {k}")
        assert specs.input_specs(cfg, SHAPES[shape_name]).keys() == {"batch"}


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_model_builds(arch):
    cfg = configs.get_config(arch)
    model = LM(cfg, device="meta")
    jparams = jspecs.param_specs_for(jconfigs.get_config(arch))
    assert model.device.type == "meta"
    assert all(p.is_meta for p in model.parameters())
    assert (sum(p.numel() for p in model.parameters())
            == sum(math.prod(x.shape) for x in jax.tree.leaves(jparams)))


@pytest.mark.parametrize("arch", ARCHS)
def test_cpu_weights_unchanged(arch):
    model = LM(configs.get_smoke_config(arch), device="cpu", seed=3)
    h = hashlib.sha256()
    for name, p in model.named_parameters():
        h.update(name.encode())
        h.update(str(p.dtype).encode())
        h.update(p.detach().contiguous().view(torch.uint8).numpy().tobytes())
    assert h.hexdigest()[:16] == WEIGHT_DIGESTS[arch]


def test_model_kernels_on_meta():
    meta = lambda *shape, dtype=torch.float32: torch.empty(shape, dtype=dtype, device="meta")
    before = (ops.flash_attention.launches, ops.rglru_scan.launches, ops.mamba_scan.launches,
              ops.causal_conv1d.launches)
    h, h_last = ops.rglru_scan(meta(2, 7, 6), meta(2, 7, 6), meta(2, 6))
    assert (h.shape, h_last.shape) == ((2, 7, 6), (2, 6))
    assert h.dtype == h_last.dtype == torch.float32 and h.is_meta and h_last.is_meta
    bf = torch.bfloat16
    y, s = ops.mamba_scan(meta(2, 7, 6, dtype=bf), meta(2, 7, 6), meta(6, 3),
                          meta(2, 7, 3, dtype=bf), meta(2, 7, 3, dtype=bf), meta(6))
    assert (y.shape, y.dtype, s.shape, s.dtype) == ((2, 7, 6), bf, (2, 6, 3), torch.float32)
    # the conv's plain version on meta: a few elementwise ops that compute nothing
    c = ops.causal_conv1d(meta(2, 7, 12, dtype=bf)[..., :6], meta(6, 4, dtype=bf),
                          meta(6, dtype=bf), silu=True)
    assert (c.shape, c.dtype, c.is_meta) == ((2, 7, 6), bf, True)
    assert before == (ops.flash_attention.launches, ops.rglru_scan.launches,
                      ops.mamba_scan.launches, ops.causal_conv1d.launches)
    with pytest.raises(ValueError, match="not meta"):
        ops.belief_aggregate(meta(2, 3, dtype=torch.int32), meta(3), 0.0, 4)
    with pytest.raises(ValueError, match="not meta"):
        ops.flash_attention(meta(2, 5, 4, 8), meta(2, 5, 2, 8), meta(2, 5, 2, 8))


DRYRUN_CELLS = ([(a, "decode_32k") for a in ARCHS]
                + [("smollm-135m", "train_4k"), ("falcon-mamba-7b", "prefill_32k"),
                   ("qwen1.5-110b", "long_500k")])


def _jax_argument_bytes(jcfg, jshape, jmesh) -> int:
    rules = jsharding.AxisRules(jmesh)
    params = jspecs.param_specs_for(jcfg)
    trees = [(params, jsharding.param_specs(params, rules))]
    if jshape.kind == "train":
        opt = jspecs.opt_specs_for(params)
        trees.append((opt, jsharding.param_specs(opt, rules)))
    if jshape.kind in ("train", "prefill"):
        batch = jspecs.batch_specs_for(jcfg, jshape)
        trees.append((batch, jsharding.batch_specs(batch, rules)))
    else:
        cache, tokens = jspecs.decode_specs_for(jcfg, jshape)
        cache = {k: v for k, v in cache.items() if k != "pos"}     # a host int in the port
        trees += [(cache, jsharding.cache_specs(cache, rules)),
                  (tokens, jsharding.batch_specs(tokens, rules))]
    total = 0
    for tree, sh in trees:
        sizes = jax.tree.map(
            lambda leaf, s: math.prod(s.shard_shape(tuple(leaf.shape))) * leaf.dtype.itemsize,
            tree, sh)
        total += sum(jax.tree.leaves(sizes))
    return total


@pytest.mark.parametrize("arch,shape_name", DRYRUN_CELLS)
def test_dryrun_cell(arch, shape_name, tmp_path):
    (rec,) = dryrun.main(["--arch", arch, "--shape", shape_name, "--out", str(tmp_path)])
    with open(tmp_path / f"{arch}__{shape_name}__16x16.json") as f:
        assert json.load(f) == json.loads(json.dumps(rec, default=float))
    jcfg, jshape = jconfigs.get_config(arch), JSHAPES[shape_name]
    assert "error" not in rec, rec.get("traceback")
    if shape_name == "long_500k":
        assert rec["skipped"] == "full-attention arch: long_500k requires sub-quadratic attention"
        return
    chips, tp = 256, 16
    fl = jroof.analytic_flops(jcfg, jshape)
    by = jroof.analytic_bytes(jcfg, jshape)
    mf = jroof.model_flops(jcfg, jshape)
    amem = jroof.analytic_memory(jcfg, jshape, dp=chips // tp, tp=tp)
    want = {
        "chips": chips, "analytic_memory": amem, "fits_hbm": amem["total"] <= 80e9,
        "analytic_flops_total": fl["total"], "analytic_flops_fwd": fl["fwd"],
        "analytic_bytes": by["total"], "model_flops": mf,
        "useful_flops_ratio": mf / fl["total"],
        "roofline": jroof.roofline_terms(fl["total"], by["total"], 0.0, chips, HW),
        "collective_bytes": None, "collective_note": "not counted: the port has no HLO",
    }
    assert {k: rec[k] for k in want} == want
    assert rec["argument_bytes_per_device"] == _jax_argument_bytes(
        jcfg, jshape, AbstractMesh((16, 16), ("data", "model")))
    # FlopCounterMode counts the matmuls; the analytic count adds the rest
    assert rec["counted_flops"] == pytest.approx(fl["total"], rel=0.35)
