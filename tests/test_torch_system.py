"""End-to-end on the port: train a small heterogeneous pool of real models
on the token classification task, calibrate success probabilities from a
historical split, then serve queries through the ThriftLLM router — the
paper's Figure-1 pipeline on live models (``tests/test_system.py``'s two
cases, driven on the port from JAX-initialised weights), and the training
CLIs run in process.

Both packages train each arm from the same JAX-initialised weights on the
same batches. The port's arms cost exactly what the JAX arms cost, and
their calibrated accuracies lie within 0.02 of the JAX package's run of
the same scenario (measured: equal on all three arms; f32 training in two
frameworks parts by rounding, see ``tests/test_torch_train.py``, so a
query near a decision boundary may flip). test_system's behavioural
asserts hold on the port.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):      # removed in jax 0.9
    jax.experimental.enable_x64 = jax.enable_x64

import json
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import make_token_task as j_make_token_task
from repro.models import LM as JaxLM
from repro.models import ModelConfig as JModelConfig
from repro.serving import LMArm as JLMArm
from repro.training import OptimizerConfig as JOpt
from repro.training import init_train_state as j_init_train_state
from repro.training import make_train_step as j_make_train_step
from repro_torch import convert, train_and_serve
from repro_torch.core.estimation import SuccessProbEstimator
from repro_torch.data import make_token_task
from repro_torch.launch import train as train_cli
from repro_torch.models import LM, ModelConfig
from repro_torch.serving import LMArm, PoolEngine, ThriftRouter
from repro_torch.training import OptimizerConfig, init_train_state, make_train_step
from _torch_serving import one_torch_thread  # noqa: F401  (autouse: torch on one CPU thread)

K = 4
SEQ = 32
VOCAB = 64
ACC_TOL = 0.02


def _cfg_fields(name, d_model, layers):
    return dict(name=name, family="dense", num_layers=layers, d_model=d_model,
                num_heads=4, num_kv_heads=2, d_ff=2 * d_model, vocab_size=VOCAB,
                dtype="float32", remat=False, tie_embeddings=True)


def _train_both(fields, seed, steps, batches, opt_fields):
    """Train one arm in each package from the JAX init; returns (JAX model,
    JAX params, port model, JAX losses, port losses)."""
    jcfg, cfg = JModelConfig(**fields), ModelConfig(**fields)
    jmodel = JaxLM(jcfg)
    jparams, jopt = j_init_train_state(jmodel, jax.random.key(seed))
    tparams, opt = convert.train_state_from_jax(jax.tree.map(np.asarray, jparams),
                                                jax.tree.map(np.asarray, jopt), cfg)
    model = LM(cfg, "cpu", params=tparams)
    params, _ = init_train_state(model)
    jstep = jax.jit(j_make_train_step(jmodel, JOpt(**opt_fields)))
    step = make_train_step(model, OptimizerConfig(**opt_fields))
    jlosses, losses = [], []
    for s in range(steps):
        toks = batches(s)
        jparams, jopt, jm = jstep(jparams, jopt, {"tokens": jnp.asarray(toks)})
        params, opt, m = step(params, opt, {"tokens": torch.from_numpy(toks)})
        jlosses.append(float(jm["loss"]))
        losses.append(float(m["loss"]))
    return jmodel, jparams, model, jlosses, losses


@pytest.fixture(scope="module")
def trained_pool():
    """test_system's pool: (data, JAX arms, port arms)."""
    data = make_token_task(K, SEQ, VOCAB, n=512, seed=0)
    jdata = j_make_token_task(K, SEQ, VOCAB, n=512, seed=0)
    np.testing.assert_array_equal(data["tokens"], jdata["tokens"])
    toks, n, bs = data["tokens"], data["tokens"].shape[0], 16
    jarms, arms = [], []
    for name, d_model, layers, steps, seed in (("tiny", 32, 1, 40, 1), ("small", 48, 2, 80, 2),
                                               ("base", 64, 2, 160, 3)):
        jmodel, jparams, model, _, _ = _train_both(
            _cfg_fields(name, d_model, layers), seed, steps,
            lambda s: toks[(s * bs) % (n - bs):(s * bs) % (n - bs) + bs],
            dict(lr=3e-3, warmup_steps=10))
        jarms.append(JLMArm(name, jmodel, jparams, data["class_token_ids"], tokens_per_query=SEQ))
        arms.append(LMArm(name, model, data["class_token_ids"], tokens_per_query=SEQ))
    return data, jarms, arms


def test_end_to_end_train_calibrate_route(trained_pool):
    data, jarms, arms = trained_pool
    engine = PoolEngine(arms)
    assert [a.cost for a in arms] == [a.cost for a in jarms]

    # --- calibrate on a held-out historical split
    hist = make_token_task(K, SEQ, VOCAB, n=256, seed=1)
    T = np.zeros((256, len(arms)))
    jT = np.zeros((256, len(arms)))
    for a, (arm, jarm) in enumerate(zip(arms, jarms)):
        T[:, a] = arm.classify_batch(hist["tokens"]) == hist["labels"]
        jT[:, a] = jarm.classify_batch(hist["tokens"]) == hist["labels"]
    acc, jacc = T.mean(axis=0), jT.mean(axis=0)
    np.testing.assert_allclose(acc, jacc, rtol=0, atol=ACC_TOL)
    # bigger arms should genuinely be better (trained longer/larger)
    assert acc[-1] > acc[0], acc
    assert arms[-1].cost > arms[0].cost

    emb = np.stack([np.bincount(t, minlength=VOCAB) for t in hist["tokens"]]).astype(float)
    est = SuccessProbEstimator(T, emb, np.zeros(256, np.int64))

    router = ThriftRouter(engine, est, num_classes=K, device="cpu")
    test = make_token_task(K, SEQ, VOCAB, n=128, seed=2)
    temb = np.stack([np.bincount(t, minlength=VOCAB) for t in test["tokens"]]).astype(float)

    budget = float(engine.costs.sum())  # generous: full ensemble affordable
    res = router.route_batch(test["tokens"], temb, budget)
    ens_acc = (res.predictions == test["labels"]).mean()
    assert (res.costs <= budget + 1e-15).all()
    # ensemble >= best single arm accuracy - small slack
    assert ens_acc >= max(acc) - 0.08, (ens_acc, acc)

    # tight budget: must still answer, using cheap arms only
    tight = float(np.sort(engine.costs)[0]) * 1.5
    res_t = router.route_batch(test["tokens"], temb, tight)
    assert (res_t.costs <= tight + 1e-15).all()
    acc_t = (res_t.predictions == test["labels"]).mean()
    assert acc_t > 1.0 / K  # far better than chance even at minimum budget


def test_training_reduces_loss():
    """test_system's loss case on the port, from JAX-initialised weights;
    the first step's loss equals JAX's (rel 1e-5)."""
    data = make_token_task(K, SEQ, VOCAB, n=256, seed=5)
    fields = dict(_cfg_fields("t", 48, 2), d_ff=96)
    _, _, _, jlosses, losses = _train_both(
        fields, 0, 100, lambda s: data["tokens"][(s * 16) % 240:(s * 16) % 240 + 16],
        dict(lr=1e-2, warmup_steps=5, total_steps=200))
    assert losses[0] == pytest.approx(jlosses[0], rel=1e-5)
    # most body tokens are iid noise (irreducible ~log V), so assert an
    # absolute drop of the learnable component rather than a ratio
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.25


def test_train_cli_runs_and_resumes(tmp_path, capsys):
    args = ["--arch", "recurrentgemma-9b", "--smoke", "--steps", "12", "--batch", "2",
            "--seq", "16", "--save-every", "5", "--ckpt", str(tmp_path), "--device", "cpu"]
    train_cli.main(args)
    first = capsys.readouterr().out.splitlines()
    assert first[0].startswith("[recurrentgemma-smoke] ") and first[0].endswith("M params, 12 steps")
    assert [l.split()[1] for l in first if l.startswith("step")] == ["0", "10", "11"]
    assert re.fullmatch(r"done in [0-9.]+s", first[-1])
    assert sorted(p.name for p in (tmp_path / "recurrentgemma-smoke").iterdir()) == [
        "step_000000000", "step_000000005", "step_000000010"]
    train_cli.main(args[:4] + ["20"] + args[5:])
    second = capsys.readouterr().out.splitlines()
    assert second[1] == "resumed from step 10"
    assert [l.split()[1] for l in second if l.startswith("step")] == ["19"]
    train_cli.main(["--arch", "recurrentgemma-9b", "--smoke", "--steps", "2", "--batch", "2",
                    "--seq", "16", "--ckpt", str(tmp_path / "int8"), "--device", "cpu",
                    "--compress", "int8"])
    third = capsys.readouterr().out.splitlines()
    assert "resumed" not in third[1]
    losses = [float(l.split()[3]) for l in first + second + third if l.startswith("step")]
    assert len(losses) == 6 and all(np.isfinite(losses))


def test_train_cli_needs_a_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the default device works")
    with pytest.raises(RuntimeError):
        train_cli.main(["--smoke", "--steps", "1", "--ckpt", str(tmp_path)])


def test_train_and_serve_runs_in_process(tmp_path, capsys):
    summary = train_and_serve.main(["--device", "cpu", "--steps", "12", "--ckpt", str(tmp_path)])
    out = capsys.readouterr().out.splitlines()
    assert json.loads(out[-1]) == summary
    names = [a[0] for a in train_and_serve.ARMS]
    assert [a["name"] for a in summary["arms"]] == names
    # the arms cost what the JAX package's arms of the same configs cost
    for arm, (name, d, layers, heads, _) in zip(summary["arms"], train_and_serve.ARMS):
        jcfg = JModelConfig(name=name, family="dense", num_layers=layers, d_model=d,
                            num_heads=heads, num_kv_heads=max(1, heads // 2), d_ff=2 * d,
                            vocab_size=train_and_serve.VOCAB, dtype="float32", remat=False,
                            tie_embeddings=True)
        want = JLMArm(name, JaxLM(jcfg), None, np.arange(4), tokens_per_query=train_and_serve.SEQ)
        assert arm["cost"] == want.cost
    cheapest = min(a["cost"] for a in summary["arms"])
    assert [b["multiple"] for b in summary["budgets"]] == list(train_and_serve.BUDGET_MULTIPLES)
    for b in summary["budgets"]:
        assert b["budget"] == cheapest * b["multiple"] and b["max_cost"] <= b["budget"] + 1e-15
    assert out[0] == "== 1. train the model pool =="
    assert sum(l.startswith("  [") and "12 steps in" in l for l in out) == len(names)
