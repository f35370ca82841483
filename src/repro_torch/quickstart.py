"""Quickstart: budget-constrained ensemble selection on a synthetic pool.

The PyTorch port's copy of ``examples/quickstart.py``, printing the same
lines: builds a 12-arm pool (Table-4-style price/quality spread),
estimates success probabilities from historical responses, and answers
queries with ThriftLLM at several budgets — the accuracy/cost frontier plus
the adaptive early-stop saving. The router plans and routes on
``--device`` (default ``cuda``).

Run:  PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]
Tiny: PYTHONPATH=src python -m repro_torch.quickstart --queries 80 --history 300
"""
import argparse

import numpy as np

from repro_torch.core.clustering import kmeans
from repro_torch.core.estimation import SuccessProbEstimator
from repro_torch.data import OracleWorkload
from repro_torch.serving import OracleArm, PoolEngine, ThriftRouter


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--queries", type=int, default=1000,
                    help="test queries per budget")
    ap.add_argument("--history", type=int, default=3000,
                    help="historical responses for calibration")
    ap.add_argument("--device", default="cuda",
                    help="where the router plans and routes")
    args = ap.parse_args(argv)

    # --- pool: 12 arms, stronger = pricier; 6 query classes, K=4 labels
    wl = OracleWorkload(num_classes=4, num_clusters=6, num_arms=12, seed=0)
    engine = PoolEngine([OracleArm(f"llm-{i}", wl, i, seed=9) for i in range(12)])
    print("pool costs (USD/query):", np.round(engine.costs, 7))

    # --- calibrate from historical responses (Section 3.1)
    T, emb, _ = wl.response_table(args.history, seed=1)
    assign, _ = kmeans(emb, 6, seed=0)
    est = SuccessProbEstimator(T, emb, assign)
    router = ThriftRouter(engine, est, num_classes=4, device=args.device)

    # --- test queries
    rng = np.random.default_rng(42)
    cid, qemb, labels = wl.sample_queries(args.queries, rng)
    queries = list(zip(cid, labels))

    print(f"\n{'budget':>12} {'accuracy':>9} {'mean cost':>11} {'saving':>7} {'arms':>5}")
    for budget in [1e-5, 5e-5, 1e-4, 5e-4, 1e-3]:
        res = router.route_batch(queries, qemb, budget)
        acc = (res.predictions == labels).mean()
        saving = 1 - res.costs.sum() / max(res.planned_costs.sum(), 1e-15)
        n_arms = np.mean([len(a) for a in res.arms_used])
        assert (res.costs <= budget + 1e-15).all()
        print(f"{budget:12.0e} {acc:9.3f} {res.costs.mean():11.3e} {saving:6.1%} {n_arms:5.1f}")

    # --- compare against the strongest affordable single arm at mid budget
    budget = 1e-4
    res = router.route_batch(queries, qemb, budget)
    best = int(np.argmax(np.where(engine.costs <= budget, wl.p_true.mean(0), -1)))
    single = np.array(
        [wl.invoke(best, int(c), int(l), rng) == l for c, l in queries]
    ).mean()
    print(f"\nat budget {budget:.0e}: ThriftLLM={np.mean(res.predictions == labels):.3f} "
          f"vs best single affordable arm={single:.3f}")


if __name__ == "__main__":
    main()
