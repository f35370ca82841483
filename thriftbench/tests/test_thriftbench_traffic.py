"""The generators repeat from a seed, carry the same work on every seed, and
map each query to its cluster; the weights repeat from a seed."""
import numpy as np
import pytest
import torch

from thriftbench.reference import router as rr
from thriftbench.tests import tiny
from thriftbench.traffic import generate as gen
from thriftbench.traffic.synth import make_token_task
from thriftbench.weights import derived, draw_arm, draw_layer

MIX = {"arrivals": "poisson", "rate_qps": 50.0, "lead_s": 1.0, "seq_len": 128, "vocab": 512,
       "budget": {"kind": "tiers", "n": 4}}
SEED = 2**31 + 977


@pytest.fixture(scope="module")
def pool():
    return tiny.pool()


def test_queries_repeat_from_a_seed(pool):
    a = gen.make_queries(pool, MIX, SEED, 64, "window")
    b = gen.make_queries(pool, MIX, SEED, 64, "window")
    c = gen.make_queries(pool, MIX, SEED + 1, 64, "window")
    for k in ("tokens", "emb", "clusters", "budgets", "labels"):
        np.testing.assert_array_equal(a[k], b[k])
    assert not np.array_equal(a["tokens"], c["tokens"])
    d = gen.make_queries(pool, MIX, SEED, 64, "window", sub=1)
    assert not np.array_equal(a["tokens"], d["tokens"])


@pytest.mark.parametrize("stream", ["history", "warmup", "profile", "window"])
def test_streams_draw_apart(pool, stream):
    other = "check" if stream != "check" else "window"
    a = gen.make_queries(pool, MIX, SEED, 16, stream)
    b = gen.make_queries(pool, MIX, SEED, 16, other)
    assert not np.array_equal(a["tokens"], b["tokens"])


def test_every_seed_carries_the_same_work(pool):
    levels = gen.budget_levels(pool, MIX)
    for seed in (1, 2, SEED):
        q = gen.make_queries(pool, MIX, seed, 120, "window")
        assert np.bincount(q["clusters"]).tolist() == [40, 40, 40]
        assert sorted(np.unique(q["budgets"], return_counts=True)[1].tolist()) == [30, 30, 30, 30]
        assert np.allclose(np.unique(q["budgets"]), levels)
        assert gen.arrivals(MIX).offsets(MIX, seed, 10.0, "window").size == 500


def test_arrivals_repeat_and_are_sorted():
    offsets = gen.arrivals(MIX).offsets
    a = offsets(MIX, SEED, 4.0, "window")
    np.testing.assert_array_equal(a, offsets(MIX, SEED, 4.0, "window"))
    assert np.all(np.diff(a) >= 0) and a.min() >= 0 and a.max() < 4.0


def test_tokens_stay_in_range_and_keep_the_task(pool):
    q = gen.make_queries(pool, MIX, SEED, 50, "window")
    t = q["tokens"]
    assert t.dtype == np.int32 and t.min() >= 0 and t.max() < MIX["vocab"]
    assert np.all(t[:, -2] == 2)
    np.testing.assert_array_equal(t[:, -1], q["labels"] + 4)
    plain = make_token_task(4, 128, 512, 50, seed=0)["tokens"]
    assert plain.shape == t.shape


def test_queries_map_to_their_cluster(pool):
    pool = dict(pool, num_clusters=6, history_per_cluster=200)
    hist = gen.make_history(pool, MIX)
    est = rr.Estimator(hist["table"], hist["emb"], hist["clusters"])
    q = gen.make_queries(pool, MIX, SEED, 90, "window")
    np.testing.assert_array_equal(est.lookup(q["emb"]), q["clusters"])


def test_history_is_the_deployments_not_the_runs(pool):
    hist = gen.make_history(pool, MIX)
    again = gen.make_history(pool, MIX)
    np.testing.assert_array_equal(hist["table"], again["table"])
    other = gen.make_history(dict(pool, history_seed=pool["history_seed"] + 1), MIX)
    assert not np.array_equal(hist["table"], other["table"])
    prices = np.asarray([a["price_usd"] for a in pool["arms"]])
    mean_p = hist["p_true"].mean(axis=0)
    assert np.argmax(mean_p) == np.argmax(prices)
    assert np.argmin(mean_p) == np.argmin(prices)


@pytest.mark.parametrize("arch", sorted(tiny.ARMS))
def test_weights_repeat_from_a_seed(arch):
    model = tiny.ARMS[arch]
    a = draw_arm(model, SEED, 1, "cpu")
    b = draw_arm(model, SEED, 1, "cpu")
    for x, y in zip(a["layers"], b["layers"]):
        assert x.keys() == y.keys()
        for k in x:
            assert torch.equal(x[k], y[k])
    c = draw_layer(model, 0, SEED, 2, "cpu")
    w = "wq" if "wq" in c else "w_in"
    assert not torch.equal(c[w], a["layers"][0][w])
    m = derived(model)
    assert a["embed"]["tok"].shape == (m["vocab_padded"], m["d_model"])
    assert a["embed"]["tok"].dtype == torch.bfloat16


@pytest.mark.parametrize("arch,name,fan_in,depth", [
    ("tiny-gqa", "wq", 96, 1), ("tiny-gqa", "wo", 96, 4), ("tiny-gqa", "wd", 128, 4),
    ("tiny-moe", "ewd", 32, 4), ("tiny-ssm", "w_in", 64, 1), ("tiny-ssm", "w_out", 128, 2)])
def test_matrices_drawn_at_their_scale(arch, name, fan_in, depth):
    """N(0, 1/fan_in), the residual projections over 2L (attention, MoE) or L (Mamba)."""
    w = draw_layer(tiny.ARMS[arch], 0, SEED, 0, "cpu")[name].float()
    assert abs(w.std().item() * np.sqrt(fan_in * depth) - 1) < 0.1


def test_mamba_dt_bias_is_the_published_range():
    b = draw_layer(tiny.ARMS["tiny-ssm"], 0, SEED, 0, "cpu")["b_dt"]
    dt = torch.nn.functional.softplus(b)
    assert dt.min() >= 1e-3 * 0.999 and dt.max() <= 1e-1 * 1.001
