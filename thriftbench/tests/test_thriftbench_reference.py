"""The plain reference computes what the program computes: the arms'
forward in float32 on the CPU for every block type the cells run, and the
control plane (xi, plans, the Prop. 4 stop) against the program's own."""
import numpy as np
import pytest
import torch

from repro_torch.core.selection import adaptive_invoke
from repro_torch.models import LM
from repro_torch.models.config import ModelConfig
from thriftbench.reference import router as rr
from thriftbench.reference.model import answer_logits
from thriftbench.tests import tiny
from thriftbench.weights import draw_arm

SEED = 2**31 + 31


@pytest.mark.parametrize("arch", sorted(tiny.ARMS))
@pytest.mark.parametrize("rows", [1, 5])
def test_forward_matches_the_program_in_f32(arch, rows):
    model = dict(tiny.ARMS[arch], dtype="float32")
    cfg = ModelConfig(**dict(model, block_pattern=tuple(model["block_pattern"])))
    lm = LM(cfg, device="cpu", params=draw_arm(model, SEED, 3, "cpu"))
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, 512, (rows, 23)))
    with torch.inference_mode():
        want = lm(tokens)[:, -1, :model["vocab_size"]].float()
    got = answer_logits(model, tokens, SEED, 3, "f32")
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-4)


def test_moe_rows_batched_by_segment_equal_their_calls():
    model = tiny.ARMS["tiny-moe"]
    rng = np.random.default_rng(2)
    calls = [torch.as_tensor(rng.integers(0, 512, (n, 15))) for n in (3, 5, 2)]
    alone = torch.cat([answer_logits(model, t, SEED, 1, "f32") for t in calls])
    together = answer_logits(model, torch.cat(calls), SEED, 1, "f32", segments=[3, 5, 2])
    torch.testing.assert_close(together, alone, rtol=1e-5, atol=1e-5)


def test_fp8_control_departs_from_the_reference():
    model = tiny.ARMS["tiny-gqa"]
    tokens = torch.as_tensor(np.random.default_rng(1).integers(0, 512, (4, 16)))
    ref = answer_logits(model, tokens, SEED, 0, "f32")
    ctrl = answer_logits(model, tokens, SEED, 0, "fp8")
    rel = ((ctrl - ref).norm() / ref.norm()).item()
    assert 1e-3 < rel < 0.5


def test_exact_xi_of_one_arm_is_its_rate():
    p = np.asarray([0.7, 0.6, 0.9])
    assert rr.exact_xi(p, [2], 4) == pytest.approx(0.9)
    assert rr.exact_xi(p, [], 4) == 0.25
    assert rr.exact_xi(p, [0, 1, 2], 4) > 0.9


def test_plans_the_reference_accepts():
    p = np.asarray([0.85, 0.7, 0.6])
    b = np.asarray([2e-6, 5e-7, 1e-7])
    assert rr.plan_ok(p, b, b.sum(), 4, [0, 1, 2])[0]
    assert not rr.plan_ok(p, b, b.sum(), 4, [1, 0, 2])[0]           # order
    assert not rr.plan_ok(p, b, 1e-6, 4, [0])[0]                     # over budget
    assert rr.plan_ok(p, b, 1e-6, 4, [1, 2])[0]
    assert not rr.plan_ok(p, b, b.sum(), 4, [1, 2])[0]               # not a candidate
    assert rr.plan_ok(p, b, b[2], 4, [2])[0]


@pytest.mark.parametrize("case", range(40))
def test_stop_and_prediction_match_the_program(case):
    rng = np.random.default_rng(case)
    L, K = 3, 4
    p = rng.uniform(0.4, 0.95, L)
    order = sorted(range(L), key=lambda a: -p[a])
    answers = {a: int(rng.integers(K)) for a in order}
    res = adaptive_invoke(order, p, K, lambda a: answers[a])
    stop, pred, _ = rr.invoke(p, K, order, answers)
    assert stop == res.used.size and pred == res.prediction


class _Cell:
    def __init__(self, check):
        self.cell = {"check": check}
        self.config = {"arms": [{"arch": a, "model": dict(tiny.ARMS[a])}
                                for a in ("tiny-gqa", "tiny-moe")]}


def _served(sizes=(16, 16, 16, 16, 9)):
    rng = np.random.default_rng(0)
    calls = []
    for arm in (0, 1):
        for n in sizes:
            calls.append((arm, rng.integers(0, 512, (n, 24)), rng.integers(0, 4, n)))
    return {"calls": calls}


def test_rows_sampled_across_calls_and_moe_by_whole_calls():
    from thriftbench.reference.check import _batch, sample_rows

    served = _served()
    cell = _Cell({"rows_per_arm": 40, "calls": {"tiny-moe": 2}})
    picks = sample_rows(cell, served, SEED)
    dense, moe = picks[0], picks[1]
    assert sum(len(r) for _, r in dense) == 40 and len(dense) > 1
    assert all(served["calls"][i][0] == 0 for i, _ in dense)
    assert len(moe) == 2 and all(len(r) == served["calls"][i][1].shape[0] for i, r in moe)
    again = sample_rows(cell, served, SEED)
    assert [(i, r.tolist()) for i, r in again[0]] == [(i, r.tolist()) for i, r in dense]
    tokens, answers, segments = _batch(served, dense)
    assert tokens.shape == (40, 24) and answers.shape == (40,) and sum(segments) == 40
    i, rows = dense[0]
    np.testing.assert_array_equal(tokens[:len(rows)], served["calls"][i][1][rows])
    few = sample_rows(_Cell({"rows_per_arm": 500, "calls": {"tiny-moe": 9}}), served, SEED)
    assert sum(len(r) for _, r in few[0]) == 73 and len(few[1]) == 5
    with pytest.raises(ValueError):
        sample_rows(_Cell({"rows_per_arm": 8}), served, SEED)
