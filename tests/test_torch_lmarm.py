"""A pool of model-backed arms on both packages: the port's ``LMArm`` and
router against the JAX package's, on the CPU.

Two pools of small arms, each arm a ``SMOKE`` config: one per dense,
hybrid and SSM family (smollm-135m, recurrentgemma-9b, falcon-mamba-7b),
and one of a MoE arm and the two frontend families' arms (granite-moe-1b-
a400m, internvl2-2b, musicgen-medium; an ``LMArm`` classifies from its
tokens alone, frontend archs included, as the JAX arm does). The arms are
initialised by the JAX package and carried across with
``convert.lm_arm_state`` / ``lm_arm_from_state``. Over ``make_token_task(4, 32, 64)`` — bitwise the
same task on both sides — the arms must give equal class ids, which only
means something if no query's top-2 class logits lie within the two
packages' logit tolerance of each other: the test asserts the smallest
top-2 margin is at least 100x that tolerance. The two routers, calibrated
from each package's own answers on a shared history, then route uniform-
and mixed-budget batches with bitwise equal predictions, costs, planned
costs and stop waves, on the device and the host reference planes.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):      # removed in jax 0.9
    jax.experimental.enable_x64 = jax.enable_x64

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke_config
from repro.core.estimation import SuccessProbEstimator
from repro.data import make_token_task as jax_make_token_task
from repro.models import LM as JaxLM
from repro.serving import LMArm as JaxLMArm
from repro.serving import PoolEngine as JaxPoolEngine
from repro.serving import ThriftRouter as JaxThriftRouter
from repro_torch import convert
from repro_torch.data import make_token_task
from repro_torch.serving import PoolEngine, ThriftRouter

# arch -> init key; keys picked so that no query's top-2 class margin comes
# within 100x LOGIT_TOL (random arms have margins down to 1e-5 on some keys)
ARCHS = {"smollm-135m": 14, "recurrentgemma-9b": 18, "falcon-mamba-7b": 14}
MOE_FRONTEND_ARCHS = {"granite-moe-1b-a400m": 9, "internvl2-2b": 28, "musicgen-medium": 20}
K, SEQ, VOCAB = 4, 32, 64
LOGIT_TOL = 1e-5       # |port - JAX| on any class logit; measured up to 6e-6 here
FIELDS = ("predictions", "costs", "planned_costs", "stop_waves", "schedule", "invoked")


def _embed(tokens):
    return np.stack([np.bincount(t, minlength=VOCAB) for t in tokens]).astype(float)


def _make_pool(archs):
    task = make_token_task(K, SEQ, VOCAB, n=8, seed=0)
    jax_arms = []
    for arch, key in archs.items():
        cfg = get_smoke_config(arch)
        model = JaxLM(cfg)
        params = jax.jit(model.init)(jax.random.key(key))
        jax_arms.append(JaxLMArm(arch, model, params, task["class_token_ids"],
                                 tokens_per_query=SEQ))
    port_arms = [convert.lm_arm_from_state(convert.lm_arm_state(a), "cpu") for a in jax_arms]
    hist = make_token_task(K, SEQ, VOCAB, n=128, seed=1)
    rng = np.random.default_rng(3)
    batches = []
    costs = np.array([a.cost for a in jax_arms])
    for i in range(2):
        test = make_token_task(K, SEQ, VOCAB, n=32, seed=2 + i)
        budget = (float(costs.sum()) if i == 0
                  else rng.choice(np.linspace(costs.min(), costs.sum(), 4), size=32))
        batches.append((test["tokens"], _embed(test["tokens"]), budget, test["labels"]))
    answers = {side: np.stack([a.classify_batch(hist["tokens"]) for a in arms], axis=1)
               for side, arms in (("jax", jax_arms), ("port", port_arms))}
    return {"jax": jax_arms, "port": port_arms, "hist": hist, "answers": answers,
            "batches": batches}


@pytest.fixture(scope="module")
def pool():
    return _make_pool(ARCHS)


@pytest.fixture(scope="module")
def moe_frontend_pool():
    return _make_pool(MOE_FRONTEND_ARCHS)


@pytest.mark.parametrize("k,seq,vocab,n,seed,noise", [
    (4, 32, 64, 50, 0, 0.0), (7, 40, 512, 33, 5, 0.2), (2, 12, 16, 10, 9, 0.0),
])
def test_make_token_task_bitwise(k, seq, vocab, n, seed, noise):
    got = make_token_task(k, seq, vocab, n, seed=seed, noise=noise)
    want = jax_make_token_task(k, seq, vocab, n, seed=seed, noise=noise)
    assert got.keys() == want.keys()
    for key in want:
        assert got[key].dtype == want[key].dtype
        np.testing.assert_array_equal(got[key], want[key])
    with pytest.raises(ValueError, match="vocab"):
        make_token_task(4, 16, 12, 3)


def test_cost_and_flops_equal(pool):
    for j, p in zip(pool["jax"], pool["port"]):
        assert p.cost == j.cost and p.flops_per_query == j.flops_per_query
        assert p.latency_s(17) == j.latency_s(17)
        assert p.name == j.name and p.tokens_per_query == j.tokens_per_query
        assert p.metered == j.metered is False


def _class_logits(arm, tokens, jax_side: bool) -> np.ndarray:
    ids = np.asarray(arm.class_token_ids)
    if jax_side:
        logits = arm._fwd(arm.params, jnp.asarray(tokens[:, :-1]))
        return np.asarray(logits[:, -1])[:, ids]
    with torch.inference_mode():
        logits = arm.model(torch.as_tensor(tokens[:, :-1]).long())
    return logits[:, -1].numpy()[:, ids]


def test_classify_batch_equal_with_margin(pool):
    """Equal class ids on every query the routes below can ask about, with
    every top-2 margin at least 100x the logit tolerance."""
    _check_classify(pool)


def test_moe_and_frontend_arms_classify_equal_with_margin(moe_frontend_pool):
    _check_classify(moe_frontend_pool)


def _check_classify(pool):
    tokens = np.concatenate([pool["hist"]["tokens"]] + [b[0] for b in pool["batches"]])
    for j, p in zip(pool["jax"], pool["port"]):
        want = _class_logits(j, tokens, jax_side=True)
        got = _class_logits(p, tokens, jax_side=False)
        err = float(np.abs(got - want).max())
        assert err <= LOGIT_TOL, (j.name, err)
        top2 = np.sort(want, axis=1)[:, -2:]
        margin = float((top2[:, 1] - top2[:, 0]).min())
        assert margin >= 100 * LOGIT_TOL, (j.name, margin)
        np.testing.assert_array_equal(p.classify_batch(tokens), j.classify_batch(tokens))
        assert p.classify_batch(tokens).dtype == np.int64


def _routers(pool):
    """Both routers over the pool, calibrated on the history. Random arms
    answer at chance (1/K), where the planner invokes nothing, so the
    history is labelled with the arms' own JAX answers in turn (query i
    takes arm i mod L's answer, L the pool's size): every arm calibrates
    well above chance and the routes run multi-arm plans wave by wave."""
    n_arms = len(pool["jax"])
    emb = _embed(pool["hist"]["tokens"])
    assign = np.zeros(len(emb), np.int64)
    answers = pool["answers"]
    rows = np.arange(len(emb))
    labels = answers["jax"][rows, rows % n_arms]
    tables = {side: (ans == labels[:, None]).astype(np.float64) for side, ans in answers.items()}
    np.testing.assert_array_equal(tables["port"], tables["jax"])
    ref = JaxThriftRouter(JaxPoolEngine(pool["jax"]),
                          SuccessProbEstimator(tables["jax"], emb, assign), K,
                          donate_buffers=False)
    port = ThriftRouter(PoolEngine(pool["port"]),
                        convert.estimator_from_history(
                            {"table": tables["port"], "emb": emb, "assign": assign}),
                        K, device="cpu")
    return ref, port


@pytest.mark.parametrize("method", ["route_batch", "route_batch_reference"])
def test_lm_pool_routes_bitwise(pool, method):
    _check_routes(pool, method)


@pytest.mark.parametrize("method", ["route_batch", "route_batch_reference"])
def test_moe_and_frontend_pool_routes_bitwise(moe_frontend_pool, method):
    _check_routes(moe_frontend_pool, method)


def _check_routes(pool, method):
    ref, port = _routers(pool)
    assert not port.engine.pooled
    served = np.zeros(len(pool["jax"]), np.int64)
    for tokens, emb, budget, labels in pool["batches"]:
        want = getattr(ref, method)(tokens, emb, budget)
        got = getattr(port, method)(tokens, emb, budget)
        for field in FIELDS:
            np.testing.assert_array_equal(getattr(got, field), getattr(want, field), err_msg=field)
        assert (got.costs <= np.asarray(budget) + 1e-15).all()
        served += got.arm_query_counts
    assert (served > 0).sum() >= 2                       # more than one arm answered
    for key, sel in ref.selector._cache.items():
        other = port.selector._cache[key]
        assert np.array_equal(sel.chosen, other.chosen) and sel.xi_est == other.xi_est
