"""The port's checkpoint/restart, the training half of its fault tolerance
and its data pipeline and tokenizer, against the JAX package's
(``tests/test_fault_checkpoint.py`` and ``tests/test_estimation_data.py``'s
data cases, driven on the port)."""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):      # removed in jax 0.9
    jax.experimental.enable_x64 = jax.enable_x64

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.data import DataPipeline as JDataPipeline
from repro.data import decode as j_decode
from repro.data import encode as j_encode
from repro.data import encode_batch as j_encode_batch
from repro.data import host_shard_fn as j_host_shard_fn
from repro.distributed import fault as jfault
from repro.models import LM as JaxLM
from repro.training import init_train_state as j_init_train_state
from repro_torch import configs, convert
from repro_torch.checkpoint import CheckpointManager
from repro_torch.data import VOCAB_SIZE, DataPipeline, decode, encode, encode_batch, host_shard_fn
from repro_torch.distributed import (FaultTolerantDriver, HeartbeatMonitor, StragglerMitigator,
                                     plan_elastic_remesh, rebatch_for_mesh)
from repro_torch.models import LM
from repro_torch.training import OptimizerConfig, init_train_state, make_train_step
from _torch_serving import one_torch_thread  # noqa: F401  (autouse: torch on one CPU thread)


def _smoke_state(dtype="float32"):
    """A port model of smollm's SMOKE config (JAX-initialised weights) and
    its fresh training state."""
    cfg = dataclasses.replace(configs.get_smoke_config("smollm-135m"), dtype=dtype)
    jcfg = dataclasses.replace(jconfigs.get_smoke_config("smollm-135m"), dtype=dtype)
    jparams, jopt = j_init_train_state(JaxLM(jcfg), jax.random.key(0))
    tparams, _ = convert.train_state_from_jax(jax.tree.map(np.asarray, jparams),
                                              jax.tree.map(np.asarray, jopt), cfg)
    model = LM(cfg, "cpu", params=tparams)
    params, opt = init_train_state(model)
    return cfg, model, params, opt


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield tree


def test_checkpoint_roundtrip(tmp_path):
    _, _, params, opt = _smoke_state()
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    mgr.save(10, {"params": params, "opt": opt})
    step, restored = mgr.restore_latest({"params": params, "opt": opt})
    assert step == 10
    for a, b in zip(_leaves(restored), _leaves({"params": params, "opt": opt})):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b.detach())
    assert sorted(os.listdir(tmp_path / "step_000000010")) == ["meta.json", "shard_0.npz"]
    assert json.loads((tmp_path / "step_000000010" / "meta.json").read_text()) == {
        "step": 10, "num_hosts": 1}


def test_checkpoint_bf16_roundtrip_bitwise(tmp_path):
    """bf16 tensors are stored as their uint16 bits (numpy has no bfloat16
    without ml_dtypes) and restored bit for bit against the template."""
    _, _, params, opt = _smoke_state("bfloat16")
    state = {"params": params, "opt": opt,
             "odd": torch.tensor([float("nan"), -0.0, 3.0e38, 1e-40]).to(torch.bfloat16)}
    assert params["tok"].dtype == torch.bfloat16
    mgr = CheckpointManager(str(tmp_path))
    mgr.save(3, state)
    with np.load(tmp_path / "step_000000003" / "shard_0.npz") as z:
        assert z["params/tok"].dtype == np.uint16 and z["opt/master/tok"].dtype == np.float32
    _, restored = mgr.restore_latest(state)
    for a, b in zip(_leaves(restored), _leaves(state)):
        assert a.dtype == b.dtype
        if a.dtype == torch.bfloat16:
            assert torch.equal(a.view(torch.int16), b.detach().view(torch.int16))
        else:
            assert torch.equal(a, b.detach())


def test_checkpoint_gc_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=2)
    state = {"x": np.arange(4)}
    for s in (1, 2, 3, 4):
        mgr.save(s, state)
    assert mgr.list_steps() == [3, 4]
    step, _ = mgr.restore_latest(state)
    assert step == 4


def test_checkpoint_skips_corrupt(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep_last=5)
    state = {"x": np.arange(4)}
    mgr.save(1, state)
    mgr.save(2, state)
    # corrupt the newest shard
    with open(os.path.join(str(tmp_path), "step_000000002", "shard_0.npz"), "wb") as f:
        f.write(b"garbage")
    step, restored = mgr.restore_latest(state)
    assert step == 1
    np.testing.assert_array_equal(restored["x"], state["x"])
    empty = CheckpointManager(str(tmp_path / "none"))
    assert empty.restore_latest(state) == (None, state)


def test_restart_resumes_training(tmp_path):
    """Crash after step k -> restore -> continue: equal to an uninterrupted
    run (the reference's atol 1e-6)."""
    cfg = configs.get_smoke_config("smollm-135m")
    rng = np.random.default_rng(0)
    batches = [{"tokens": rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)}
               for _ in range(6)]

    def fresh():
        _, model, params, opt = _smoke_state()
        return make_train_step(model, OptimizerConfig(lr=1e-3, warmup_steps=1)), params, opt

    mgr = CheckpointManager(str(tmp_path))
    driver = FaultTolerantDriver(mgr, save_every=2)

    # run 1: steps 0..3, checkpointing every 2 (crash after step 3)
    step_fn, p, o = fresh()
    for s in range(4):
        p, o, _ = step_fn(p, o, batches[s])
        driver.maybe_save(s, {"params": p, "opt": o})
    # run 2: a new process's model, restore (latest is step 2) and replay 3..5
    step_fn, p0, o0 = fresh()
    state, start = driver.restore({"params": p0, "opt": o0})
    assert start == 3
    p2, o2 = state["params"], state["opt"]
    assert p2["tok"] is not p0["tok"]           # restored tensors, copied in by the step
    for s in range(start, 6):
        p2, o2, _ = step_fn(p2, o2, batches[s])
    # reference: uninterrupted run
    step_fn, pr, orr = fresh()
    for s in range(6):
        pr, orr, _ = step_fn(pr, orr, batches[s])
    for k in pr:
        np.testing.assert_allclose(p2[k].detach().numpy(), pr[k].detach().numpy(), atol=1e-6)
    assert int(o2["step"]) == int(orr["step"]) == 6


def test_heartbeat_detection_matches_reference():
    got, want = HeartbeatMonitor(num_workers=4, timeout_s=10.0), jfault.HeartbeatMonitor(4, 10.0)
    now = 1000.0
    for mon in (got, want):
        for w in range(4):
            mon.beat(w, t=now)
        mon.beat(2, t=now + 50)
    assert got.dead_workers(now=now + 55) == want.dead_workers(now=now + 55) == [0, 1, 3]
    assert got.dead_workers(now=now + 5) == want.dead_workers(now=now + 5) == []


def test_elastic_remesh_plan_matches_reference():
    shape = {"pod": 2, "data": 16, "model": 16}
    for failed, per_row in (([5], 1), ([], 1), ([0, 1, 2, 3], 2), ([3, 40, 41], 4),
                            (list(range(40)), 1)):
        assert plan_elastic_remesh(shape, failed, per_row) == jfault.plan_elastic_remesh(
            shape, failed, per_row)
    assert plan_elastic_remesh(shape, [5]) == {"pod": 2, "data": 15, "model": 16}
    for args in ((256, 16, 15), (256, 16, 16), (100, 8, 3)):
        assert rebatch_for_mesh(*args) == jfault.rebatch_for_mesh(*args)
    assert rebatch_for_mesh(256, 16, 15) == 240


def test_straggler_detection_matches_reference():
    got, want = StragglerMitigator(4, threshold=2.0), jfault.StragglerMitigator(4, threshold=2.0)
    rng = np.random.default_rng(1)
    for i in range(30):
        times = [1.0, 1.1, 0.9, 5.0] if i < 5 else list(rng.uniform(0.5, 3.0, 4))
        got.record_step(times)
        want.record_step(times)
        assert got.stragglers() == want.stragglers()
    for pending, slow in (([0, 3, 2], 3), ([1, 2], 3), ([], 0)):
        assert got.hedge_plan(pending, slow) == want.hedge_plan(pending, slow)


def test_driver_saves_and_restores_as_the_reference(tmp_path):
    saves = {}

    class Recorder:
        def __init__(self, tag):
            self.tag = tag

        def save(self, step, state):
            saves.setdefault(self.tag, []).append(step)

        def restore_latest(self, template):
            return (7, "state") if self.tag.endswith("full") else (None, template)

    for tag, cls in (("port", FaultTolerantDriver), ("ref", jfault.FaultTolerantDriver)):
        drv = cls(Recorder(tag), save_every=3)
        for s in range(10):
            drv.maybe_save(s, None)
        assert drv.restore("t") == ("t", 0)
        assert cls(Recorder(tag + "full")).restore("t") == ("state", 8)
        mon = HeartbeatMonitor(2, timeout_s=1.0)
        mon.beat(0, t=0.0)
        mon.beat(1, t=1e12)
        assert drv.check_failures(mon) == [0]
    assert saves["port"] == saves["ref"] == [0, 3, 6, 9]


def test_pipeline_prefetch_and_shard_matches_reference():
    def make(step):
        return {"x": np.full((8, 2), step), "y": np.arange(8 * 3).reshape(8, 3) + step}

    got = DataPipeline(make, shard_fn=host_shard_fn(1, 2), prefetch=2)
    want = JDataPipeline(make, shard_fn=j_host_shard_fn(1, 2), prefetch=2)
    try:
        for _ in range(5):
            a, b = next(got), next(want)
            assert a.keys() == b.keys() and a["x"].shape == (4, 2)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    finally:
        got.close()
        want.close()
    assert not got._thread.is_alive()
    with pytest.raises(AssertionError):
        host_shard_fn(0, 3)({"x": np.zeros((8, 1))})


def test_tokenizer_matches_reference():
    for s in ("hello ThriftLLM", "", "ünïcödé ✓", "a" * 40):
        assert decode(encode(s)) == s
        np.testing.assert_array_equal(encode(s), j_encode(s))
        np.testing.assert_array_equal(encode(s, max_len=12), j_encode(s, max_len=12))
        assert decode(encode(s, max_len=12)) == j_decode(j_encode(s, max_len=12))
    texts = ["abc", "de", "ThriftLLM routes"]
    np.testing.assert_array_equal(encode_batch(texts, 10), j_encode_batch(texts, 10))
    assert VOCAB_SIZE == 260
