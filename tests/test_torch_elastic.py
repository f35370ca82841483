"""The elastic re-mesh restart on the port (``tests/test_elastic.py``'s
scenario at half size): smollm-135m SMOKE trains 3 steps on a 2x2 mesh of
four gloo ranks at global batch 8 and saves its sharded state as step 2;
a data row is lost (``plan_elastic_remesh`` -> ``{data: 1, model: 2}``,
``rebatch_for_mesh`` -> 4), and a world of two ranks restores the
checkpoint through ``FaultTolerantDriver`` onto its own 1x2 mesh and
takes 3 steps at global batch 4.

JAX's four checks hold: the restored step is 2, the new mesh and batch
are as planned, and all 6 losses are finite. Besides: only host 0 wrote
the checkpoint (the whole state, as an unsharded save writes it), the
restored parameters are laid out for the new mesh, and the resumed losses
equal those of an unsharded process resumed from the same checkpoint on
the same batches (rel 1e-5).

The training launcher's ``--mesh``: ``launch/train.py --smoke --mesh 2x2``
on the four ranks prints the losses the unsharded launcher prints, on
rank 0 alone, and a rerun on a 1x2 world resumes from its checkpoint.
"""
import os
import types

import numpy as np
import pytest
import torch

import _torch_ep as ep
import _torch_sharded as sh
from repro_torch.checkpoint import CheckpointManager
from repro_torch.distributed import (AxisRules, param_specs, plan_elastic_remesh,
                                     rebatch_for_mesh)
from repro_torch.launch import train
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import LM
from repro_torch.training import OptimizerConfig, init_train_state, make_train_step
from _torch_serving import one_torch_thread  # noqa: F401  (autouse: torch on one CPU thread)

ARCH, CHANGES = "smollm-135m", {"num_microbatches": 1}
OPT = {"lr": 1e-3}
SHAPE1 = {"data": 2, "model": 2}
BATCH1, SEQ, STEPS, SAVE_STEP = 8, 16, 3, 2
REL = 1e-5


def _batches(vocab: int, b: int, rng) -> list:
    return [{"tokens": rng.integers(0, vocab, (b, SEQ)).astype(np.int64)} for _ in range(STEPS)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    ckpt = str(tmp / "ckpt")
    cfg = sh._cfg(ARCH, CHANGES)
    rng = np.random.default_rng(0)
    common = {"arch": ARCH, "changes": CHANGES, "opt": OPT, "ckpt_dir": ckpt,
              "save_step": SAVE_STEP}
    first = ep.run_world(str(tmp), {**common, "phase": "train",
                                    "batches": _batches(cfg.vocab_size, BATCH1, rng)},
                         work=sh.elastic_world, mesh_shape=(SHAPE1["data"], SHAPE1["model"]))
    files = sorted(os.listdir(os.path.join(ckpt, f"step_{SAVE_STEP:09d}")))
    new_shape = plan_elastic_remesh(SHAPE1, failed_hosts=[1], hosts_per_data_row=1)
    new_batch = rebatch_for_mesh(BATCH1, SHAPE1["data"], new_shape["data"])
    batches2 = _batches(cfg.vocab_size, new_batch, rng)
    second = ep.run_world(str(tmp), {**common, "phase": "resume", "batches": batches2},
                          work=sh.elastic_world,
                          mesh_shape=(new_shape["data"], new_shape["model"]))
    return types.SimpleNamespace(first=first, second=second, files=files, cfg=cfg, ckpt=ckpt,
                                 new_shape=new_shape, new_batch=new_batch, batches2=batches2)


def test_elastic_plan(run):
    assert run.new_shape == {"data": 1, "model": 2}
    assert run.new_batch == 4
    assert len(run.first) == 4 and len(run.second) == 2


def test_restored_step_and_finite_losses(run):
    for r in run.second:
        assert r["restored_step"] == SAVE_STEP
    losses = run.first[0]["losses"] + run.second[0]["losses"]
    assert len(losses) == 2 * STEPS
    assert np.isfinite(losses).all()
    for world in (run.first, run.second):
        assert all(r["losses"] == world[0]["losses"] for r in world)


def test_host_zero_alone_writes_the_whole_state(run):
    assert run.files == ["meta.json", "shard_0.npz"]
    model = LM(run.cfg, device="cpu", seed=0)
    params, opt = init_train_state(model)
    with np.load(os.path.join(run.ckpt, f"step_{SAVE_STEP:09d}", "shard_0.npz")) as z:
        for name, p in params.items():
            assert z[f"params/{name}"].shape == tuple(p.shape)
            assert z[f"opt/master/{name}"].shape == tuple(p.shape)


def test_restored_state_is_laid_out_for_the_new_mesh(run):
    named = dict(LM(run.cfg, device="meta").named_parameters())
    specs = param_specs(named, AxisRules(make_debug_mesh(run.new_shape["data"],
                                                         run.new_shape["model"])))
    want = {k: specs[k].shard_shape(p.shape) for k, p in named.items()}
    assert any(want[k] != tuple(p.shape) for k, p in named.items())
    for r in run.second:
        assert r["restored_shapes"] == want


def test_resumed_losses_match_an_unsharded_resume(run):
    model = LM(run.cfg, device="cpu", seed=0)
    params, opt = init_train_state(model)
    step_no, state = CheckpointManager(run.ckpt).restore_latest({"params": params, "opt": opt})
    assert step_no == SAVE_STEP
    assert int(state["opt"]["step"]) == STEPS                      # the trained state
    assert any(not torch.equal(state["params"][k], p) for k, p in params.items())
    step = make_train_step(model, OptimizerConfig(**OPT))
    params, opt = state["params"], state["opt"]
    losses = []
    for b in run.batches2:
        params, opt, m = step(params, opt, sh._batch(b))
        losses.append(float(m["loss"]))
    assert run.second[0]["losses"] == pytest.approx(losses, rel=REL)


CLI = ["--arch", ARCH, "--smoke", "--save-every", "5", "--device", "cpu"]


def _loss_lines(lines) -> list:
    return [line for line in lines if line.startswith("step ")]


def test_training_launcher_under_a_mesh(tmp_path, capsys):
    ckpt = str(tmp_path / "ckpt")
    ranks = ep.run_world(str(tmp_path), {"argv": CLI + ["--steps", "12", "--ckpt", ckpt,
                                                        "--mesh", "2x2"]},
                         work=sh.cli_world)
    first = next(r for r in ranks if r["coords"] == (0, 0))["lines"]
    assert [r["lines"] for r in ranks if r["coords"] != (0, 0)] == [[]] * 3
    train.main(CLI + ["--steps", "12", "--ckpt", str(tmp_path / "plain")])
    plain = capsys.readouterr().out.strip().splitlines()
    assert _loss_lines(first) == _loss_lines(plain) != []
    resumed = ep.run_world(str(tmp_path), {"argv": CLI + ["--steps", "15", "--ckpt", ckpt,
                                                          "--mesh", "1x2"]},
                           work=sh.cli_world, mesh_shape=(1, 2))
    lines = next(r for r in resumed if r["coords"] == (0, 0))["lines"]
    assert "resumed from step 10" in lines and _loss_lines(lines)[-1].startswith("step   14")
