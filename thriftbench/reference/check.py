"""What decides ``correct``: the program's outputs of the window held to the
plain reference, each number beside its limit.

Numbers (limits in ``thriftbench/workloads/<cell>.json``):

* ``unfinished`` — queries due in the window that never completed (limit 0);
* ``plan_mismatch`` — queries whose cluster, or whose wave plan, is not one
  the reference works out (:func:`thriftbench.reference.router.plan_ok`), or
  whose planned arms did not all answer (limit 0);
* ``agg_mismatch`` — queries whose stop wave or prediction differs from the
  reference's Alg. 3 over the arms' own answers, away from float32 ties
  (limit 0);
* ``cost_mismatch`` — queries whose realized cost is not the sum of the
  configuration's prices of the arms invoked, or is over the budget, or
  whose budget is not the one submitted (limit 0);
* ``gap.<arm>`` — over every row of a sample of each arm's rows drawn from
  the seed (:func:`sample_rows`): how far the logit of the class the arm served lies below the
  best class logit of the f32 reference on the same rows, in units of the
  reference's logit spread over the vocabulary at that position; the
  widest such gap;
* ``mean.<arm>`` — over the same rows, the mean gap: for an arm whose
  widest gap swings with a few rows, as a MoE arm's does where rounding
  flips a router's choice near a tie. The cell file gives a limit to the
  numbers it judges each arm by.
"""
from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from thriftbench.reference import router as rr
from thriftbench.reference.model import answer_logits
from thriftbench.traffic import generate as gen
from thriftbench.weights import derived, load_block

INVALID_GAP = 1e9      # the gap of an answer that is no class at all


def collect(prog: Dict, win: Dict) -> Dict:
    """Host copies of what the window's stretch served: per route, its rows'
    query ids, schedules, the arms' answers, and what each query's future
    reported; and every arm call."""
    feed = win["feed"]
    bank = feed.bank
    n = bank.next
    pred = np.full(n, -1, np.int64)
    cost = np.full(n, np.nan)
    stop = np.full(n, -1, np.int64)
    cluster = np.full(n, -1, np.int64)
    budget = np.full(n, np.nan)
    for ids, blk in feed.every:
        pred[ids], cost[ids], stop[ids] = blk.predictions, blk.costs, blk.stop_waves
        cluster[ids], budget[ids] = blk.clusters, blk.budgets
    where = {bank.tokens[i].tobytes(): i for i in range(n)}
    calls = prog["calls"]
    routes = []
    L = len(prog["arms"])
    for t_begin, pending, lo, hi in prog["routes"]:
        res = pending.result()
        payload = np.asarray(pending.payloads)
        qids = np.asarray([where[row.tobytes()] for row in payload], np.int64)
        at = {row.tobytes(): r for r, row in enumerate(payload)}
        answers = np.full((qids.size, L), -1, np.int64)
        for arm, tokens, out, _, _ in calls[lo:hi]:
            for row, a in zip(np.asarray(tokens), np.asarray(out)):
                answers[at[row.tobytes()], arm] = a
        routes.append({"qids": qids, "schedule": np.asarray(res.schedule), "answers": answers,
                       "t": t_begin, "handed": sum(int(np.asarray(c[1]).shape[0])
                                                   for c in calls[lo:hi])})
    return {"routes": routes, "calls": [(c[0], np.asarray(c[1]), np.asarray(c[2])) for c in calls],
            "pred": pred, "cost": cost, "stop": stop, "cluster": cluster, "budget": budget,
            "emb": bank.emb[:n], "budget_in": bank.budgets[:n], "failed": 0}


def router_counts(cell, seed: int, served: Dict) -> Dict[str, int]:
    """plan, aggregation and cost mismatches over every routed query."""
    pool = cell.config
    K = pool["num_classes"]
    prices = np.asarray([a["price_usd"] for a in pool["arms"]], np.float64)
    hist = gen.make_history(pool, cell.mix)
    est = rr.Estimator(hist["table"], hist["emb"], hist["clusters"])
    bad = {"plan_mismatch": 0, "agg_mismatch": 0, "cost_mismatch": 0}
    plans: Dict = {}
    failed = set()
    for route in served["routes"]:
        qids = route["qids"]
        ref_cluster = est.lookup(served["emb"][qids])
        for r, q in enumerate(qids):
            order = [int(a) for a in route["schedule"][r] if a >= 0]
            budget = float(served["budget_in"][q])
            c = int(ref_cluster[r])
            p = est.rates(c)
            key = (c, budget, tuple(order))
            if key not in plans:
                plans[key] = rr.plan_ok(p, prices, budget, K, order)[0]
            answers = {a: int(route["answers"][r, a]) for a in order
                       if route["answers"][r, a] >= 0}
            if (int(served["cluster"][q]) != c or not plans[key]
                    or len(answers) != len(order)):
                bad["plan_mismatch"] += 1
                failed.add(int(q))
            s_ref, pred_ref, ambiguous = rr.invoke(p, K, order, answers)
            s, pred = int(served["stop"][q]), int(served["pred"][q])
            if (s != s_ref or pred != pred_ref) and not ambiguous:
                bad["agg_mismatch"] += 1
                failed.add(int(q))
            spent = float(np.sum(prices[order[:max(s, 0)]]))
            c_prog = float(served["cost"][q])
            if (not abs(c_prog - spent) <= 1e-12 * max(spent, 1e-30)
                    or c_prog > budget * (1 + 1e-12)
                    or float(served["budget"][q]) != budget):
                bad["cost_mismatch"] += 1
                failed.add(int(q))
    served["failed"] += len(failed)
    return bad


def sample_rows(cell, served: Dict, seed: int) -> Dict[int, List[Tuple[int, np.ndarray]]]:
    """Each arm's sampled rows, drawn from the seed, as (call index, row
    indices) pairs. An arm named in the cell file's ``check.calls`` is
    sampled by that many whole calls; every other arm by
    ``check.rows_per_arm`` rows drawn from all its calls. An arm with a
    layer whose block file sets ``BATCH_COUPLED`` (a MoE layer's capacity
    counts the tokens of the batch a row was served in) has to be named
    there. An arm that served fewer is checked whole."""
    check = cell.cell["check"]
    arms = cell.config["arms"]
    whole = check.get("calls", {})
    rng = gen.rng_for(seed, "check")
    by_arm: Dict[int, List[int]] = {}
    for i, (arm, _, _) in enumerate(served["calls"]):
        by_arm.setdefault(arm, []).append(i)
    picks = {}
    for arm, idx in sorted(by_arm.items()):
        arch = arms[arm]["arch"]
        sizes = np.asarray([served["calls"][i][1].shape[0] for i in idx])
        if arch in whole:
            chosen = rng.choice(len(idx), size=min(int(whole[arch]), len(idx)), replace=False)
            picks[arm] = [(idx[c], np.arange(sizes[c])) for c in sorted(chosen.tolist())]
            continue
        coupled = sorted({t for t in derived(arms[arm]["model"])["layer_types"]
                          if load_block(t).BATCH_COUPLED})
        if coupled:
            raise ValueError(f"{arch} has {coupled} layers, which couple the rows of a batch: "
                             "check.calls has to sample it by whole calls")
        ends = np.cumsum(sizes)
        flat = np.sort(rng.choice(int(ends[-1]), size=min(int(check["rows_per_arm"]), int(ends[-1])),
                                  replace=False))
        call_of = np.searchsorted(ends, flat, side="right")
        picks[arm] = [(idx[c], flat[call_of == c] - (ends[c] - sizes[c]))
                      for c in np.unique(call_of).tolist()]
    return picks


def gaps(logits: torch.Tensor, cls_ids, served_cls: np.ndarray) -> np.ndarray:
    """Per row: (best class logit - the served class's) / the logits' spread."""
    lg = logits.double().cpu()
    cls = lg[:, torch.as_tensor(np.asarray(cls_ids), dtype=torch.long)]
    spread = lg.std(dim=1)
    out = np.full(served_cls.size, INVALID_GAP)
    ok = (served_cls >= 0) & (served_cls < cls.shape[1])
    idx = torch.as_tensor(np.where(ok, served_cls, 0))
    g = ((cls.max(dim=1).values - cls.gather(1, idx[:, None])[:, 0]) / spread).numpy()
    out[ok] = g[ok]
    return out


def _batch(served: Dict, picks: List[Tuple[int, np.ndarray]]):
    """The sampled rows as one reference batch: their tokens, the answers
    served, and the rows taken from each call (a MoE layer's capacity counts
    the tokens of the batch a row was served in; its calls are taken whole)."""
    calls = [(served["calls"][i], rows) for i, rows in picks]
    return (np.concatenate([c[1][rows] for c, rows in calls]),
            np.concatenate([c[2][rows] for c, rows in calls]),
            [len(rows) for _, rows in calls])


def summary(g: np.ndarray, prefix: str) -> Dict[str, float]:
    """The widest gap and the mean gap."""
    return {prefix: float(g.max()), f"{prefix}_mean": float(g.mean())}


def forward_gaps(cell, seed: int, served: Dict, dev: torch.device, precision: str = "f32",
                 picks: Dict[int, List[Tuple[int, np.ndarray]]] = None,
                 log=lambda msg: None) -> Dict[str, Dict]:
    """Per arm, over its sampled rows: the gaps of the program's answers,
    and, with another ``precision``, of the control's own answers."""
    pool = cell.config
    cls_ids = gen.make_queries(pool, cell.mix, seed, 1, "warmup")["class_token_ids"]
    cls_dev = torch.as_tensor(np.asarray(cls_ids), device=dev).long()
    if picks is None:
        picks = sample_rows(cell, served, seed)
    out = {}
    for arm, taken in picks.items():
        t0 = time.monotonic()
        spec = pool["arms"][arm]
        tokens, answers, segments = _batch(served, taken)
        x = torch.as_tensor(tokens[:, :-1], device=dev).long()
        ref = answer_logits(spec["model"], x, seed, arm, "f32", segments)
        g = gaps(ref, cls_ids, answers)
        out[spec["arch"]] = {**summary(g, "program"), "rows": int(g.size), "calls": len(taken)}
        if precision != "f32":
            ctrl = answer_logits(spec["model"], x, seed, arm, precision, segments)
            picked = ctrl[:, cls_dev].argmax(dim=1).cpu().numpy()
            out[spec["arch"]].update(summary(gaps(ref, cls_ids, picked), "control"))
        del ref
        log(f"reference {spec['arch']}: {g.size} rows from {len(taken)} calls in "
            f"{time.monotonic() - t0} s")
    return out


def served_numbers(cell, seed: int, served: Dict, win: Dict) -> Dict[str, int]:
    """The numbers of what the front door reported: unfinished queries and
    the plan, aggregation and cost mismatches."""
    done = served["pred"][win["attempted"]] >= 0
    values = {"unfinished": int(np.count_nonzero(~done))}
    served["failed"] += values["unfinished"]
    values.update(router_counts(cell, seed, served))
    return values


def arm_numbers(cell, fwd: Dict[str, Dict], side: str, log) -> Dict[str, float]:
    """Each arm's numbers that the cell file gives a limit, from the gaps of
    ``side``'s answers (``program``, or ``control`` in its place)."""
    limits = cell.cell["limits"]
    values = {}
    for arch, g in fwd.items():
        numbers = {f"gap.{arch}": g[side], f"mean.{arch}": g[f"{side}_mean"]}
        judged = {k: v for k, v in numbers.items() if k in limits}
        if not judged:
            log(f"no limit is set for any number of {arch}: its gap fails")
            judged = {f"gap.{arch}": g[side]}
        values.update(judged)
    return values


def beside_limits(cell, values: Dict[str, float]) -> Dict[str, Dict]:
    """Each number beside its limit (one with no limit fails)."""
    limits = cell.cell["limits"]
    return {name: {"value": value, "limit": limits.get(name, -1.0)}
            for name, value in values.items()}


def passes(checks: Dict[str, Dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def judge(cell, seed: int, served: Dict, win: Dict, dev: torch.device, log) -> Dict[str, Dict]:
    """Every number the run is judged by, beside its limit."""
    values = served_numbers(cell, seed, served, win)
    values.update(arm_numbers(cell, forward_gaps(cell, seed, served, dev, log=log),
                              "program", log))
    return beside_limits(cell, values)
