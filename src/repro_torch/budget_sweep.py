"""Budget sweep of the paper's comparison (the shape of Figures 4 and 6):
ThriftLLM's accuracy and mean cost per budget against the baselines —
SurGreedyLLM without the adaptive early stop, a FrugalGPT-style cascade,
top-k weighted, the best affordable single arm, and LLM-Blender-style
use-all. The PyTorch port's copy of ``examples/budget_sweep.py``; the
router plans and routes on ``device``, the baselines are numpy.

Run:  PYTHONPATH=src python -m repro_torch.budget_sweep [--device cpu]
"""
from __future__ import annotations

import argparse
from typing import Dict, Sequence, Tuple

import numpy as np

from repro_torch.core import FrugalCascade, blender_all, single_best, topk_weighted
from repro_torch.core.belief import aggregate_predict
from repro_torch.core.clustering import kmeans
from repro_torch.core.estimation import SuccessProbEstimator
from repro_torch.data import OracleWorkload
from repro_torch.serving import OracleArm, PoolEngine, ThriftRouter

BUDGETS = [1e-5, 5e-5, 1e-4, 5e-4, 1e-3]
COLUMNS = ("Thrift", "SurGreedy", "cascade", "top-k", "single")


def run_baseline_agg(chosen, wl, p_hat, queries, rng, K, costs):
    """Invoke a fixed subset on every query + ML aggregation."""
    acc, cost = 0, 0.0
    for cid, label in queries:
        resp = [wl.invoke(int(a), int(cid), int(label), rng) for a in chosen]
        pred = aggregate_predict(np.asarray(resp), p_hat[chosen], K, p_all=p_hat)
        acc += pred == label
        cost += costs[chosen].sum()
    return acc / len(queries), cost / len(queries)


def sweep(queries: int = 600, history: int = 3000, budgets: Sequence[float] = BUDGETS,
          device="cuda") -> Dict:
    """Run the sweep. Returns ``{"rows": {budget: {column: (accuracy, mean
    cost)}}, "blender": (accuracy, cost)}`` with the columns of
    :data:`COLUMNS`; the router plans and routes on ``device``."""
    K = 4
    wl = OracleWorkload(num_classes=K, num_clusters=6, num_arms=12, seed=0)
    engine = PoolEngine([OracleArm(f"llm{i}", wl, i, seed=5) for i in range(12)])
    costs = engine.costs

    T, emb, _ = wl.response_table(history, seed=1)
    assign, _ = kmeans(emb, 6, seed=0)
    est = SuccessProbEstimator(T, emb, assign)
    router = ThriftRouter(engine, est, num_classes=K, device=device)

    rng = np.random.default_rng(7)
    cid, qemb, labels = wl.sample_queries(queries, rng)
    queries = list(zip(cid, labels))
    cl_of = est.lookup_batch(qemb)

    rows: Dict[float, Dict[str, Tuple[float, float]]] = {}
    for budget in budgets:
        # --- ThriftLLM (adaptive)
        res = router.route_batch(queries, qemb, budget)
        th = ((res.predictions == labels).mean(), res.costs.mean())

        # --- SurGreedyLLM (no adaptive early stop): planned-cost invocation
        sg_acc, sg_cost = 0.0, 0.0
        inv_rng = np.random.default_rng(11)
        for (q, c) in zip(queries, cl_of):
            p = est.clusters[int(c)].p_hat
            sel = router.selector.select(p, K, budget)
            a, co = run_baseline_agg(np.asarray(sel.chosen, int), wl, p, [q], inv_rng, K, costs)
            sg_acc += a
            sg_cost += co
        sg = (sg_acc / len(queries), sg_cost / len(queries))

        # --- FrugalGPT-style cascade (strict per-query budget for fairness)
        casc = FrugalCascade(costs, margin=2.0, strict=True)
        c_acc, c_cost = 0.0, 0.0
        inv_rng = np.random.default_rng(13)
        for (cidq, label), c in zip(queries, cl_of):
            p = est.clusters[int(c)].p_hat
            r = casc.answer(
                p, K, budget,
                lambda a: wl.invoke(a, int(cidq), int(label), inv_rng),
            )
            c_acc += r.prediction == label
            c_cost += r.cost
        ca = (c_acc / len(queries), c_cost / len(queries))

        # --- top-k weighted under budget (LLM-Ensemble-ish)
        inv_rng = np.random.default_rng(17)
        tk_acc, tk_cost = 0.0, 0.0
        for (q, c) in zip(queries, cl_of):
            p = est.clusters[int(c)].p_hat
            chosen = topk_weighted(p, costs, budget)
            a, co = run_baseline_agg(chosen, wl, p, [q], inv_rng, K, costs)
            tk_acc += a
            tk_cost += co
        tk = (tk_acc / len(queries), tk_cost / len(queries))

        # --- best affordable single arm
        inv_rng = np.random.default_rng(19)
        sb_acc, sb_cost = 0.0, 0.0
        for (q, c) in zip(queries, cl_of):
            p = est.clusters[int(c)].p_hat
            chosen = single_best(p, costs, budget)
            a, co = run_baseline_agg(chosen, wl, p, [q], inv_rng, K, costs)
            sb_acc += a
            sb_cost += co
        sb = (sb_acc / len(queries), sb_cost / len(queries))
        rows[budget] = dict(zip(COLUMNS, (th, sg, ca, tk, sb)))

    # --- LLM-Blender-style: all arms, majority fusion, budget-unaware
    inv_rng = np.random.default_rng(23)
    bl_acc = 0.0
    for (cidq, label) in queries:
        r = blender_all(
            wl.p_true.mean(0), K,
            lambda a: wl.invoke(a, int(cidq), int(label), inv_rng), costs,
        )
        bl_acc += r.prediction == label
    return {"rows": rows, "blender": (bl_acc / len(queries), float(costs.sum()))}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--queries", type=int, default=600)
    ap.add_argument("--history", type=int, default=3000)
    ap.add_argument("--budgets", type=float, nargs="*", default=BUDGETS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = sweep(args.queries, args.history, list(args.budgets), device=args.device)

    print(f"{'budget':>9} | {'Thrift':>14} | {'SurGreedy':>14} | {'cascade':>14} | "
          f"{'top-k':>14} | {'single':>14}")
    print(f"{'':>9} | " + " | ".join([f"{'acc':>6} {'cost':>7}"] * 5))
    for budget, cols in out["rows"].items():
        row = " | ".join(f"{a:6.3f} {c:7.1e}" for a, c in cols.values())
        print(f"{budget:9.0e} | {row}")
    bl_acc, bl_cost = out["blender"]
    print(f"\nLLM-Blender-style (all 12 arms, majority): acc={bl_acc:.3f} "
          f"cost={bl_cost:.1e} (budget-unaware)")


if __name__ == "__main__":
    main()
