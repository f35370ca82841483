"""The port's roofline accounting against the JAX package's
(``repro/launch/roofline.py``).

* ``analytic_flops``, ``analytic_bytes``, ``model_flops``, ``_cache_bytes``
  and ``analytic_memory`` at both production layouts' ``(dp, tp)`` equal
  the JAX package's exactly (``==``) for every arch x shape: the counts
  are ported in the same arithmetic order.
* ``roofline_terms`` and ``wire_bytes_per_chip`` on
  ``tests/test_roofline.py``'s inputs, and its 6ND case.
* ``flop_count`` (``FlopCounterMode``, the counterpart of XLA's
  ``cost_analysis``) of the port's plain forward on
  ``tests/test_roofline.py``'s one-layer tiny config is within that test's
  tolerance (rel 0.35) of ``analytic_flops(...)["fwd"]``, and counts the
  same on ``meta`` as on the CPU.
* ``HW`` holds the H100 SXM5's datasheet constants.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):      # removed in jax 0.9
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import roofline as jroof
from repro.launch.mesh import HW as TPU_HW
from repro.models import SHAPES as JSHAPES
from repro.models import ModelConfig as JaxModelConfig
from repro.models import ShapeConfig as JaxShapeConfig
from repro_torch import configs
from repro_torch.launch import roofline as troof
from repro_torch.launch.mesh import HW
from repro_torch.models import LM, SHAPES, ModelConfig, ShapeConfig

ARCHS = configs.list_archs()
DP_TP = ((16, 16), (32, 16))        # 16x16 and 2x16x16: model axis 16, the rest data


@pytest.mark.parametrize("shape_name", list(SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_analytic_counts_equal_jax(arch, shape_name):
    cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
    shape, jshape = SHAPES[shape_name], JSHAPES[shape_name]
    assert troof.analytic_flops(cfg, shape) == jroof.analytic_flops(jcfg, jshape)
    assert troof.analytic_bytes(cfg, shape) == jroof.analytic_bytes(jcfg, jshape)
    assert troof.model_flops(cfg, shape) == jroof.model_flops(jcfg, jshape)
    for p_bytes in (2.0, 4.0):
        assert (troof._cache_bytes(cfg, shape, p_bytes)
                == jroof._cache_bytes(jcfg, jshape, p_bytes))
    for dp, tp in DP_TP:
        assert (troof.analytic_memory(cfg, shape, dp=dp, tp=tp)
                == jroof.analytic_memory(jcfg, jshape, dp=dp, tp=tp))


ROOFLINE_CASES = (
    # tests/test_roofline.py::test_roofline_terms_bottleneck
    dict(flops=1000.0, hbm_bytes=10.0, collective_bytes=0.1, chips=1,
         hw={"peak_flops": 100.0, "hbm_bw": 10.0, "ici_bw": 1.0}),
    dict(flops=1.0, hbm_bytes=1000.0, collective_bytes=0.0, chips=1,
         hw={"peak_flops": 100.0, "hbm_bw": 10.0, "ici_bw": 1.0}),
    # the per-chip wire form and the card's constants
    dict(flops=3e15, hbm_bytes=2e12, collective_bytes=5e9, chips=256, hw=HW,
         wire_per_chip=7e9),
    dict(flops=1e12, hbm_bytes=4e12, collective_bytes=0.0, chips=512, hw=HW),
)


@pytest.mark.parametrize("case", range(len(ROOFLINE_CASES)))
def test_roofline_terms_equal_jax(case):
    kw = ROOFLINE_CASES[case]
    assert troof.roofline_terms(**kw) == jroof.roofline_terms(**kw)


def test_roofline_terms_bottleneck():
    hw = {"peak_flops": 100.0, "hbm_bw": 10.0, "ici_bw": 1.0}
    t = troof.roofline_terms(flops=1000.0, hbm_bytes=10.0, collective_bytes=0.1, chips=1, hw=hw)
    assert t["bottleneck"] == "compute_s"
    assert t["compute_s"] == pytest.approx(10.0)
    t2 = troof.roofline_terms(flops=1.0, hbm_bytes=1000.0, collective_bytes=0.0, chips=1, hw=hw)
    assert t2["bottleneck"] == "memory_s"


def test_wire_bytes_per_chip_equal_jax():
    coll = {"all-gather": 3e6, "all-reduce": 5e6, "reduce-scatter": 1e6, "all-to-all": 2e6,
            "collective-permute": 7e5, "total": 1.17e7, "unscoped_while": 0.0}
    assert troof.WIRE_FACTOR == jroof.WIRE_FACTOR
    assert troof.wire_bytes_per_chip(coll) == jroof.wire_bytes_per_chip(coll)
    assert troof.wire_bytes_per_chip(coll) == 3e6 + 2 * 5e6 + 1e6 + 2e6 + 7e5


def _tiny(cls, **kw):
    base = dict(
        name="tiny", family="dense", num_layers=2, d_model=64, num_heads=4,
        num_kv_heads=2, d_ff=128, vocab_size=256, dtype="float32", remat=False,
        tie_embeddings=True,
    )
    base.update(kw)
    return cls(**base)


def test_model_flops_train_is_6nd():
    cfg = _tiny(ModelConfig)
    shape = ShapeConfig("t", seq_len=64, global_batch=2, kind="train")
    assert troof.model_flops(cfg, shape) == 6.0 * cfg.active_param_count() * 128
    assert troof.model_flops(cfg, shape) == jroof.model_flops(
        _tiny(JaxModelConfig), JaxShapeConfig("t", seq_len=64, global_batch=2, kind="train"))


def test_counted_flops_match_the_analytic_count():
    """``tests/test_roofline.py``'s check against XLA, with
    ``FlopCounterMode`` in XLA's place (it too counts only matmul/conv
    FLOPs; the analytic count adds elementwise ones)."""
    cfg = _tiny(ModelConfig, num_layers=1)
    shape = ShapeConfig("t", seq_len=128, global_batch=4, kind="prefill")
    tokens = np.random.default_rng(0).integers(0, cfg.vocab_size, (4, 128))
    model = LM(cfg, device="cpu", seed=0)
    with torch.no_grad():
        counted = troof.flop_count(model, torch.as_tensor(tokens))
        meta = troof.flop_count(LM(cfg, device="meta"),
                                torch.empty((4, 128), dtype=torch.long, device="meta"))
    ours = troof.analytic_flops(cfg, shape)["fwd"]
    assert ours == pytest.approx(counted, rel=0.35), (ours, counted)
    assert meta == counted > 0


def test_hw_is_the_h100():
    assert HW == {"peak_flops": 989e12, "hbm_bw": 3.35e12, "ici_bw": 450e9, "hbm_bytes": 80e9}
    assert set(HW) == set(TPU_HW)         # the JAX table's keys: roofline_terms reads them
