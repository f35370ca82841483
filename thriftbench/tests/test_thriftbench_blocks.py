"""An architecture enters as files only: a toy block type and a toy kernel,
written to directories the lookups are pointed at, are drawn, run through
the reference, counted in FLOPs and launches and read as a roofline, with
no existing file of ``thriftbench/`` touched. An unknown block type and an
arm whose program builds other layers than the benchmark draws both raise."""
import hashlib
import importlib
import json
import os
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import thriftbench.blocks
import thriftbench.rooflines
from thriftbench import harness, weights
from thriftbench.metrics import _shared, arith
from thriftbench.reference.check import sample_rows
from thriftbench.reference.model import answer_logits, mm, rmsnorm
from thriftbench.spec import Cell
from thriftbench.tests import tiny

BENCH = Path(__file__).resolve().parents[1]
SEED = 2**31 + 909

TOY_BLOCK = '''"""A toy block: an RMSNorm and a GELU MLP with its residual."""
import torch.nn.functional as F

from thriftbench.reference.model import mm, rmsnorm

BATCH_COUPLED = False


def spec(m):
    D, F_ = m["d_model"], m["d_ff"]
    return [("ln", (D,), "zeros", 0), ("w1", (D, F_), "mat", D), ("wd", (F_, D), "mat", F_)]


def residual_depth(m):
    return m["num_layers"]


def forward(h, p, m, precision, segments):
    x = rmsnorm(h, p["ln"], m["norm_eps"])
    return h + mm(F.gelu(mm(x, p["w1"], precision)), p["wd"], precision)


def flops(m, S):
    return S * 4 * m["d_model"] * m["d_ff"]


def launches(m):
    return {"toy": 2}
'''

TOY_KERNEL = '''"""A toy kernel: its bytes, one activation in and one out."""
from thriftbench.metrics.arith import BF16, PEAK_BF16_FLOPS, roofline_bound

COUNTER = "causal_conv1d"
ROW = "toy_kernel"


def bound(m, btype, B, S):
    return roofline_bound(float(B * S * 4 * m["d_model"] * m["d_ff"]),
                          float(BF16 * 2 * B * S * m["d_model"]), PEAK_BF16_FLOPS)
'''

MODEL = dict(tiny.BASE, name="tiny-toy", num_layers=3, layer_types=["attn", "toy", "toy"],
             tie_embeddings=False)


def sources():
    """A digest of every source and data file of the benchmark."""
    h = hashlib.sha256()
    for p in sorted(BENCH.rglob("*")):
        if p.suffix in (".py", ".json") and "__pycache__" not in p.parts:
            h.update(str(p).encode() + p.read_bytes())
    return h.hexdigest()


@pytest.fixture
def toy_files(tmp_path, monkeypatch):
    """The block and kernel packages given a directory each, first on their
    path, that holds the toy file; yields the toy's block directory."""
    before = sources()
    for package, text in ((thriftbench.blocks, TOY_BLOCK), (thriftbench.rooflines, TOY_KERNEL)):
        folder = tmp_path / package.__name__.rpartition(".")[2]
        folder.mkdir()
        (folder / "toy.py").write_text(text)
        monkeypatch.setattr(package, "__path__", [str(folder)] + list(package.__path__))
    importlib.invalidate_caches()
    yield tmp_path / "blocks"
    for name, mod in list(sys.modules.items()):
        if str(tmp_path) in str(getattr(mod, "__file__", None)):
            del sys.modules[name]
            package, _, leaf = name.rpartition(".")
            delattr(sys.modules[package], leaf)
    assert sources() == before


@pytest.fixture
def toy(toy_files):
    """The toy model's sizes, with its files found."""
    return weights.derived(MODEL)


def test_toy_layers_are_drawn_by_their_file(toy):
    lay = weights.draw_arm(MODEL, SEED, 0, "cpu")
    assert "wq" in lay["layers"][0]
    D, F_, L = toy["d_model"], toy["d_ff"], toy["num_layers"]
    for layer in lay["layers"][1:]:
        assert {k: tuple(v.shape) for k, v in layer.items()} == {"ln": (D,), "w1": (D, F_),
                                                                 "wd": (F_, D)}
    wd = torch.cat([layer["wd"].float().flatten() for layer in lay["layers"][1:]])
    assert abs(wd.std().item() * np.sqrt(F_ * L) - 1) < 0.1       # residual depth L
    again = weights.draw_layer(MODEL, 2, SEED, 0, "cpu")
    assert torch.equal(again["w1"], lay["layers"][2]["w1"])


@pytest.mark.parametrize("precision", ["f32", "fp8"])
def test_toy_reference_runs_the_toy_forward(toy, precision):
    tokens = torch.as_tensor(np.random.default_rng(4).integers(0, 512, (3, 11)))
    got = answer_logits(MODEL, tokens, SEED, 0, precision)
    ends = weights.draw_ends(MODEL, SEED, 0, "cpu")
    h = ends["tok"][tokens].float()
    h = weights.load_block("attn").forward(h, weights.draw_layer(MODEL, 0, SEED, 0, "cpu"), toy,
                                           precision, [3])
    for i in (1, 2):
        p = weights.draw_layer(MODEL, i, SEED, 0, "cpu")
        x = rmsnorm(h, p["ln"], toy["norm_eps"])
        h = h + mm(F.gelu(mm(x, p["w1"], precision)), p["wd"], precision)
    want = mm(rmsnorm(h[:, -1], ends["final_norm"], toy["norm_eps"]), ends["head"],
              precision)[:, :toy["vocab_size"]]
    assert torch.equal(got, want)


@pytest.mark.parametrize("S", [1, 7, 127])
def test_toy_flops_are_its_files(toy, S):
    D, F_, V = toy["d_model"], toy["d_ff"], toy["vocab_size"]
    attn = weights.load_block("attn").flops(toy, S)
    assert arith.forward_flops(MODEL, S) == attn + 2 * S * 4 * D * F_ + 2 * D * V


def test_toy_launches_are_counted_and_checked(toy):
    from repro_torch.kernels import ops

    assert arith.launches(MODEL) == {"flash_attention": 1, "toy": 4}
    assert arith.attention_layers(MODEL) == 1 and arith.ssm_layers(MODEL) == 0
    assert "toy" in arith.kernel_names()
    counts = harness.launch_counts()
    assert counts["toy_kernel"] == ops.causal_conv1d.launches
    assert {"flash_attention_kernel", "mamba_scan_kernel", "belief_aggregate_kernel"} <= set(counts)
    cell = types.SimpleNamespace(config={"arms": [{"model": MODEL}]})
    calls = [(0,), (0,)]
    delta = {"toy_kernel": 8, "flash_attention_kernel": 2, "mamba_scan_kernel": 0,
             "causal_conv1d_kernel": 0}
    assert harness.launch_mismatches(cell, calls, delta) == []
    bad = harness.launch_mismatches(cell, calls, dict(delta, toy_kernel=7))
    assert len(bad) == 1 and bad[0].startswith("toy: 7 launches counted, 8")


def test_toy_roofline_is_found_by_name(toy):
    B, seq = 5, 23
    device_s = 2e-6
    rows = [(f"void toy_kernel<{i}>", 0.0, device_s / 8 * 1e6) for i in range(8)]
    ctx = {"slice": {"rows": rows, "calls": [(0, np.zeros((B, seq)), None, 0, 0)] * 2},
           "cell": types.SimpleNamespace(mix={"seq_len": seq + 1}),
           "pool": {"arms": [{"model": MODEL}]}, "log": lambda msg: None}
    one = arith.load_kernel("toy").bound(toy, "toy", B, seq)["bound_s"]
    assert _shared.roofline(ctx, "toy") == pytest.approx(100 * 8 * one / device_s, rel=1e-12)
    assert _shared.roofline(ctx, "flash_attention") is None           # no rows of it


@pytest.mark.parametrize("qk,v", [(128, 128), (192, 128)])
def test_flash_bound_takes_the_layers_head_dims(toy, toy_files, qk, v):
    """A block whose q/k head dim differs from its v head dim (latent
    attention's 128 + 64 against 128) gives its flash launches' shape."""
    (toy_files / "split.py").write_text(
        "def flash_shape(m):\n"
        f"    return {{'heads': 16, 'kv_heads': 16, 'qk_dim': {qk}, 'v_dim': {v}, 'window': 0}}\n")
    importlib.invalidate_caches()
    B, S = 3, 9
    got = arith.load_kernel("flash_attention").bound(toy, "split", B, S)
    pairs = S * (S + 1) // 2
    assert got["ops"] == 2 * B * 16 * pairs * (qk + v)          # QK^T at qk, PV at v
    assert got["bytes"] == 2 * B * S * 16 * (qk + qk + v + v)   # q, k, v read, o written
    if qk == v:
        assert got == arith.flash_launch(dict(MODEL, num_heads=16, num_kv_heads=16,
                                              head_dim=qk, window=0), B, S)


@pytest.mark.parametrize("arch,want", [
    ("tiny-gqa", {"flash_attention": 2}), ("tiny-moe", {"flash_attention": 2}),
    ("tiny-ssm", {"mamba_scan": 2, "causal_conv1d": 2})])
def test_each_block_files_launches(arch, want):
    """One flash launch an attention or MoE layer; a Mamba layer's conv (with
    its bias and SiLU) and its scan, one launch each."""
    assert arith.launches(tiny.ARMS[arch]) == want
    assert set(arith.kernel_names()) >= set(want)


@pytest.mark.parametrize("use", ["spec", "draw", "reference", "flops", "launches"])
def test_an_unknown_block_type_raises_and_names_its_file(use):
    model = dict(MODEL, layer_types=["attn", "nope", "attn"])
    call = {"spec": lambda: weights.layer_spec(weights.derived(model), "nope"),
            "draw": lambda: weights.draw_layer(model, 1, SEED, 0, "cpu"),
            "reference": lambda: answer_logits(model, torch.zeros((1, 4), dtype=torch.long),
                                               SEED, 0),
            "flops": lambda: arith.forward_flops(model, 7),
            "launches": lambda: arith.launches(model)}[use]
    with pytest.raises(ValueError, match=r"blocks/nope\.py is missing"):
        call()


def test_an_unknown_kernel_raises_and_names_its_file():
    with pytest.raises(ValueError, match=r"rooflines/nope\.py is missing"):
        arith.load_kernel("nope")


@pytest.mark.parametrize("listed", [["attn"], ["attn", "attn", "attn"]])
def test_layer_types_of_another_depth_raise(listed):
    with pytest.raises(ValueError, match="layer_types lists"):
        weights.derived(dict(tiny.ARMS["tiny-gqa"], layer_types=listed))


@pytest.mark.parametrize("listed,builds", [(["attn", "attn"], True), (["attn", "moe"], False),
                                           (["moe", "attn"], False)])
def test_build_refuses_layers_the_program_does_not_build(tmp_path, listed, builds):
    root = tiny.checkout(tmp_path, arms=("tiny-gqa", "tiny-window"))
    path = root / "thriftbench" / "configs" / "tiny-pool.json"
    pool = json.loads(path.read_text())
    pool["arms"][0]["model"]["layer_types"] = listed
    path.write_text(json.dumps(pool))
    cell = Cell(root, "tiny.backlog")
    if builds:
        prog = harness.build(cell, SEED, torch.device("cpu"), False, lambda m: None)
        assert len(prog["arms"]) == 2
    else:
        with pytest.raises(ValueError, match="the program builds layers"):
            harness.build(cell, SEED, torch.device("cpu"), False, lambda m: None)


def test_build_refuses_a_key_the_program_lacks(tmp_path):
    """Only the benchmark's own keys are kept from the program: a published
    feature that ``ModelConfig`` has no field for is refused, not ignored."""
    root = tiny.checkout(tmp_path, arms=("tiny-gqa", "tiny-window"))
    path = root / "thriftbench" / "configs" / "tiny-pool.json"
    pool = json.loads(path.read_text())
    pool["arms"][0]["model"]["routed_scaling_factor"] = 2.446
    path.write_text(json.dumps(pool))
    with pytest.raises(TypeError, match="routed_scaling_factor"):
        harness.build(Cell(root, "tiny.backlog"), SEED, torch.device("cpu"), False, lambda m: None)


@pytest.mark.parametrize("listed,calls,refused", [
    (["attn", "attn"], {}, False), (["attn", "moe"], {}, True), (["moe", "attn"], {}, True),
    (["attn", "moe"], {"tiny-mixed": 2}, False)])
def test_rows_of_a_batch_coupled_layer_are_sampled_by_whole_calls(listed, calls, refused):
    """An arm is sampled by whole calls when any of its layers' block files
    sets ``BATCH_COUPLED``, whatever its ``block_pattern`` says."""
    model = dict(tiny.ARMS["tiny-gqa"], layer_types=listed)
    cell = types.SimpleNamespace(cell={"check": {"rows_per_arm": 8, "calls": calls}},
                                 config={"arms": [{"arch": "tiny-mixed", "model": model}]})
    rng = np.random.default_rng(1)
    served = {"calls": [(0, rng.integers(0, 512, (n, 24)), rng.integers(0, 4, n))
                        for n in (16, 16, 9)]}
    assert [weights.load_block(t).BATCH_COUPLED for t in ("attn", "moe", "ssm")] == [
        False, True, False]
    if refused:
        with pytest.raises(ValueError, match=r"\['moe'\] layers"):
            sample_rows(cell, served, SEED)
    else:
        picks = sample_rows(cell, served, SEED)[0]
        if calls:
            assert [len(r) for _, r in picks] == [served["calls"][i][1].shape[0]
                                                  for i, _ in picks] and len(picks) == 2
        else:
            assert sum(len(r) for _, r in picks) == 8


def test_a_new_pool_leaves_the_frozen_checks_alone(tmp_path):
    """A pool file added beside the others, with an arm of a block type that
    no file holds yet, leaves the frozen checks of a checkout passing: they
    read only the arms ``frozen.json`` names."""
    root = tiny.checkout(tmp_path)
    new = dict(tiny.ARMS["tiny-gqa"], name="tiny-new", layer_types=["attn", "latent"])
    (root / "thriftbench" / "configs" / "new-pool.json").write_text(json.dumps(
        dict(tiny.pool(("tiny-gqa",)), name="new-pool",
             arms=[{"arch": "tiny-new", "source": "test", "price_usd": 1e-9, "model": new}])))
    run = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider", "-p", "no:randomly",
         "thriftbench/tests/test_thriftbench_frozen.py"],
        cwd=root, capture_output=True, text=True, timeout=600,
        env=dict(os.environ, PYTHONPATH=str(root)))
    assert run.returncode == 0, run.stdout[-4000:] + run.stderr[-2000:]
    frozen = json.loads((BENCH / "tests" / "frozen.json").read_text())
    tiny_arms = sum(1 for v in frozen.values() if "draws" in v)
    assert re.search(rf"\b{2 + len(frozen) + 2 * tiny_arms} passed", run.stdout), run.stdout[-2000:]
