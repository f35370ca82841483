"""The budget sweep of ``examples/budget_sweep.py`` (ThriftLLM against the
paper's baselines) run by the JAX package and by the port
(``repro_torch.budget_sweep`` on the CPU), at ``tests/test_examples.py``'s
tiny size: every column's (accuracy, mean cost) is exactly equal.

The JAX side is the example's loop with its own modules, returning the
numbers the example prints rounded.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):      # removed in jax 0.9
    jax.experimental.enable_x64 = jax.enable_x64

import numpy as np
import pytest

from repro.core import FrugalCascade, blender_all, single_best, topk_weighted
from repro.core.clustering import kmeans
from repro.core.estimation import SuccessProbEstimator
from repro.data import OracleWorkload
from repro.serving import OracleArm, PoolEngine, ThriftRouter
from repro_torch import budget_sweep

QUERIES, HISTORY, BUDGETS = 30, 300, [1e-4, 5e-4]


def _reference_sweep(queries, history, budgets):
    """``examples/budget_sweep.py:main`` on the JAX package, numbers kept."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "examples" / "budget_sweep.py"
    spec = importlib.util.spec_from_file_location("_example_budget_sweep", path)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    run_baseline_agg = example.run_baseline_agg

    K = 4
    wl = OracleWorkload(num_classes=K, num_clusters=6, num_arms=12, seed=0)
    engine = PoolEngine([OracleArm(f"llm{i}", wl, i, seed=5) for i in range(12)])
    costs = engine.costs
    T, emb, _ = wl.response_table(history, seed=1)
    assign, _ = kmeans(emb, 6, seed=0)
    est = SuccessProbEstimator(T, emb, assign)
    router = ThriftRouter(engine, est, num_classes=K)
    rng = np.random.default_rng(7)
    cid, qemb, labels = wl.sample_queries(queries, rng)
    queries = list(zip(cid, labels))
    cl_of = est.lookup_batch(qemb)

    def fixed_subset(pick, seed):
        acc, cost = 0.0, 0.0
        inv_rng = np.random.default_rng(seed)
        for (q, c) in zip(queries, cl_of):
            p = est.clusters[int(c)].p_hat
            a, co = run_baseline_agg(pick(p), wl, p, [q], inv_rng, K, costs)
            acc += a
            cost += co
        return acc / len(queries), cost / len(queries)

    rows = {}
    for budget in budgets:
        res = router.route_batch(queries, qemb, budget)
        th = ((res.predictions == labels).mean(), res.costs.mean())
        sg = fixed_subset(lambda p: np.asarray(router.selector.select(p, K, budget).chosen, int), 11)
        casc = FrugalCascade(costs, margin=2.0, strict=True)
        c_acc, c_cost = 0.0, 0.0
        inv_rng = np.random.default_rng(13)
        for (cidq, label), c in zip(queries, cl_of):
            r = casc.answer(est.clusters[int(c)].p_hat, K, budget,
                            lambda a: wl.invoke(a, int(cidq), int(label), inv_rng))
            c_acc += r.prediction == label
            c_cost += r.cost
        ca = (c_acc / len(queries), c_cost / len(queries))
        tk = fixed_subset(lambda p: topk_weighted(p, costs, budget), 17)
        sb = fixed_subset(lambda p: single_best(p, costs, budget), 19)
        rows[budget] = dict(zip(budget_sweep.COLUMNS, (th, sg, ca, tk, sb)))
    inv_rng = np.random.default_rng(23)
    bl_acc = 0.0
    for (cidq, label) in queries:
        r = blender_all(wl.p_true.mean(0), K,
                        lambda a: wl.invoke(a, int(cidq), int(label), inv_rng), costs)
        bl_acc += r.prediction == label
    return {"rows": rows, "blender": (bl_acc / len(queries), float(costs.sum()))}


@pytest.fixture(scope="module")
def sweeps():
    return (budget_sweep.sweep(QUERIES, HISTORY, BUDGETS, device="cpu"),
            _reference_sweep(QUERIES, HISTORY, BUDGETS))


@pytest.mark.parametrize("budget", BUDGETS)
@pytest.mark.parametrize("column", budget_sweep.COLUMNS)
def test_sweep_column_equals_reference(sweeps, budget, column):
    port, ref = sweeps
    got, want = port["rows"][budget][column], ref["rows"][budget][column]
    assert (float(got[0]), float(got[1])) == (float(want[0]), float(want[1]))


def test_blender_equals_reference(sweeps):
    port, ref = sweeps
    assert port["blender"] == ref["blender"]


def test_sweep_main_prints_the_table(sweeps, capsys, monkeypatch):
    """``main`` passes its arguments to ``sweep`` and prints one row per
    budget plus the blender footer, as the example does."""
    port, _ = sweeps
    calls = []
    monkeypatch.setattr(budget_sweep, "sweep", lambda *a, **k: calls.append((a, k)) or port)
    budget_sweep.main(["--queries", "30", "--history", "300", "--budgets", "1e-4", "5e-4",
                       "--device", "cpu"])
    assert calls == [((QUERIES, HISTORY, BUDGETS), {"device": "cpu"})]
    out = capsys.readouterr().out
    assert "Thrift" in out and "cascade" in out and "LLM-Blender-style" in out
    rows = [line for line in out.splitlines() if line.strip().startswith(("1e-04", "5e-04"))]
    assert len(rows) == 2, out
    assert f"{port['rows'][1e-4]['Thrift'][0]:6.3f}" in rows[0]
