"""End-to-end driver: TRAIN a pool of real models, CALIBRATE their success
probabilities on a historical split, then SERVE batched classification
queries through the ThriftLLM router with per-query budgets — the paper's
Figure-1 pipeline with live models, plus checkpoint/restart.

The PyTorch port's copy of ``examples/train_and_serve.py``, printing the
same lines, on ``--device`` (default ``cuda``; a missing card is an error).
Each arm's initial weights are drawn on the CPU from a seed made from its
name by CRC-32 and then moved to ``--device``, so the card and the CPU
train from the same numbers (the JAX example hashes the name with
Python's per-process ``hash``, so its runs differ from one another). The last line is a JSON
summary: per arm its accuracy on the historical split, cost and mean loss
over the first and last 10 steps; per budget the routed accuracy and the
mean and largest cost.

Run:  PYTHONPATH=src python -m repro_torch.train_and_serve [--steps 300] [--device cpu]
"""
import argparse
import json
import os
import time
import zlib
from pathlib import Path

import numpy as np

from repro_torch.checkpoint import CheckpointManager
from repro_torch.core.estimation import SuccessProbEstimator
from repro_torch.data import DataPipeline, make_token_task
from repro_torch.models import LM, ModelConfig
from repro_torch.serving import LMArm, PoolEngine, ThriftRouter
from repro_torch.training import OptimizerConfig, init_train_state, make_train_step

K = 8          # classes
SEQ = 64
VOCAB = 512
BUDGET_MULTIPLES = (1.2, 2.5, 5.0, 100.0)      # of the cheapest arm's cost

ARMS = [
    # (name, d_model, layers, heads, train_steps)
    ("nano", 32, 1, 2, 120),
    ("micro", 48, 2, 4, 200),
    ("tiny", 64, 2, 4, 300),
    ("small", 96, 3, 4, 300),
]


def train_arm(name, d_model, layers, heads, steps, data, ckpt_dir, device, batch=32):
    """Train one arm; returns ``(LMArm, per-step losses)``."""
    cfg = ModelConfig(
        name=name, family="dense", num_layers=layers, d_model=d_model,
        num_heads=heads, num_kv_heads=max(1, heads // 2), d_ff=2 * d_model,
        vocab_size=VOCAB, dtype="float32", remat=False, tie_embeddings=True,
    )
    # drawn on the CPU and moved, so every device trains from the same weights
    model = LM(cfg, device="cpu", seed=zlib.crc32(name.encode()) % 2**31).to(device)
    params, opt = init_train_state(model)
    step_fn = make_train_step(model, OptimizerConfig(lr=6e-3, warmup_steps=20, total_steps=steps))
    mgr = CheckpointManager(os.path.join(ckpt_dir, name), keep_last=2)

    toks = data["tokens"]
    n = toks.shape[0]

    def make_batch(s):
        i = (s * batch) % (n - batch)
        return {"tokens": toks[i : i + batch]}

    pipe = DataPipeline(make_batch, prefetch=2)
    start, losses = 0, []
    t0 = time.time()
    restored_step, state = mgr.restore_latest({"params": params, "opt": opt})
    if restored_step is not None:
        params, opt = state["params"], state["opt"]
        start = restored_step + 1
        print(f"  [{name}] resumed from checkpoint step {restored_step}")
    try:
        for s in range(start, steps):
            params, opt, m = step_fn(params, opt, next(pipe))
            losses.append(float(m["loss"]))
            if s % 100 == 0 and s:
                mgr.save(s, {"params": params, "opt": opt})
    finally:
        pipe.close()
    print(
        f"  [{name}] {cfg.param_count()/1e6:.2f}M params, {steps} steps in "
        f"{time.time()-t0:.1f}s, loss {losses[0]:.3f} -> {np.mean(losses[-10:]):.3f}"
    )
    return LMArm(name, model, data["class_token_ids"], tokens_per_query=SEQ), losses


def embed_queries(tokens):
    return np.stack([np.bincount(t, minlength=VOCAB) for t in tokens]).astype(float)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=0, help="override per-arm steps")
    ap.add_argument("--ckpt", default=str(Path(__file__).resolve().parents[2]
                                          / "build" / "train_ckpt" / "train_and_serve"))
    ap.add_argument("--device", default="cuda",
                    help="where the arms train and answer and the router plans "
                         "(cuda needs a card; cpu runs the plain versions)")
    args = ap.parse_args(argv)

    print("== 1. train the model pool ==")
    data = make_token_task(K, SEQ, VOCAB, n=4096, seed=0)
    arms, losses = [], []
    for name, d, l, h, steps in ARMS:
        arm, arm_losses = train_arm(name, d, l, h, args.steps or steps, data, args.ckpt,
                                    args.device)
        arms.append(arm)
        losses.append(arm_losses)
    engine = PoolEngine(arms)

    print("\n== 2. calibrate success probabilities (Section 3.1) ==")
    hist = make_token_task(K, SEQ, VOCAB, n=1024, seed=1)
    T = np.zeros((1024, len(arms)))
    for a, arm in enumerate(arms):
        T[:, a] = arm.classify_batch(hist["tokens"]) == hist["labels"]
    for arm, acc in zip(arms, T.mean(0)):
        print(f"  {arm.name:6s} acc={acc:.3f} cost={arm.cost:.3e} USD/query")
    est = SuccessProbEstimator(T, embed_queries(hist["tokens"]), np.zeros(1024, np.int64))

    print("\n== 3. serve with ThriftLLM under per-query budgets ==")
    router = ThriftRouter(engine, est, num_classes=K, device=args.device)
    test = make_token_task(K, SEQ, VOCAB, n=512, seed=2)
    temb = embed_queries(test["tokens"])
    print(f"{'budget':>12} {'accuracy':>9} {'mean cost':>11} {'saving':>7}")
    served = []
    for mult in BUDGET_MULTIPLES:
        budget = float(np.sort(engine.costs)[0]) * mult
        res = router.route_batch(test["tokens"], temb, budget)
        acc = (res.predictions == test["labels"]).mean()
        saving = 1 - res.costs.sum() / max(res.planned_costs.sum(), 1e-15)
        assert (res.costs <= budget + 1e-15).all()
        print(f"{budget:12.3e} {acc:9.3f} {res.costs.mean():11.3e} {saving:6.1%}")
        served.append({"multiple": mult, "budget": budget, "accuracy": float(acc),
                       "mean_cost": float(res.costs.mean()), "max_cost": float(res.costs.max())})
    summary = {
        "arms": [{"name": arm.name, "accuracy": float(acc), "cost": arm.cost,
                  "loss_first10": float(np.mean(ls[:10])), "loss_last10": float(np.mean(ls[-10:]))}
                 for arm, acc, ls in zip(arms, T.mean(0), losses)],
        "budgets": served,
    }
    print(json.dumps(summary))
    return summary


if __name__ == "__main__":
    main()
