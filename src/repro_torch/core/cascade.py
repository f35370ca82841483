"""Baseline selectors the paper compares against (Section 5 / 6); numpy,
the PyTorch port's copy of ``repro/core/cascade.py``.

* :class:`FrugalCascade` — FrugalGPT-style cost-ascending cascade with a
  belief-margin confidence gate; budget enforced only in expectation
  (faithful to the paper's criticism) with an optional strict per-query mode.
* :func:`blender_all` — LLM-Blender-style use-everything baseline with
  majority fusion (no budget awareness).
* :func:`topk_weighted` — LLM-Ensemble-style greedy top-weight under budget.
* :func:`single_best` / :func:`random_subset` — sanity baselines.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import numpy as np

from .belief import aggregate_predict, empty_log_belief, log_weight, top2_beliefs
from .types import InvocationResult, clip_probs


@dataclasses.dataclass
class FrugalCascade:
    """Cost-ascending cascade: invoke the cheapest arm, escalate while the
    belief margin H1 - H2 is below ``margin`` and expected budget remains.

    FrugalGPT's scorer is a learned model; our gate uses the calibrated
    belief margin, which plays the same role (confidence of the current
    answer). ``strict`` switches to per-query budget enforcement for the
    fairness-adjusted comparison in the paper's Section 6.2.
    """

    costs: np.ndarray
    margin: float = 1.0
    strict: bool = False

    def answer(
        self,
        p: np.ndarray,
        num_classes: int,
        budget: float,
        invoke_fn: Callable[[int], int],
        rng: Optional[np.random.Generator] = None,
    ) -> InvocationResult:
        p = clip_probs(p)
        b = np.asarray(self.costs, np.float64)
        K = int(num_classes)
        w = log_weight(p, K)
        empty = empty_log_belief(p)
        order = np.argsort(b, kind="stable")

        beliefs = np.full(K, empty, np.float64)
        counts = np.zeros(K, np.int64)
        used: List[int] = []
        responses: List[int] = []
        spent = 0.0
        for arm in order:
            if self.strict and spent + b[arm] > budget + 1e-15:
                continue
            if not self.strict and spent >= budget:
                break
            r = int(invoke_fn(int(arm)))
            used.append(int(arm))
            responses.append(r)
            spent += float(b[arm])
            beliefs[r] = w[arm] if counts[r] == 0 else beliefs[r] + w[arm]
            counts[r] += 1
            h1, h2, _ = top2_beliefs(beliefs)
            if h1 - h2 >= self.margin:
                break
        # FrugalGPT adopts only the LAST executed model's response:
        pred = responses[-1] if responses else (int(rng.integers(K)) if rng else 0)
        return InvocationResult(
            prediction=int(pred),
            used=np.asarray(used, np.int64),
            responses=np.asarray(responses, np.int64),
            cost=spent,
            planned_cost=spent,
            log_beliefs=beliefs,
        )


def blender_all(
    p: np.ndarray,
    num_classes: int,
    invoke_fn: Callable[[int], int],
    costs: np.ndarray,
    rng: Optional[np.random.Generator] = None,
) -> InvocationResult:
    """Use-all-arms baseline with majority fusion (LLM-Blender analogue)."""
    L = len(p)
    responses = np.asarray([int(invoke_fn(i)) for i in range(L)], np.int64)
    pred = aggregate_predict(responses, np.asarray(p), num_classes, method="majority", rng=rng)
    return InvocationResult(
        prediction=pred,
        used=np.arange(L),
        responses=responses,
        cost=float(np.sum(costs)),
        planned_cost=float(np.sum(costs)),
        log_beliefs=np.zeros(num_classes),
    )


def topk_weighted(
    p: np.ndarray, costs: np.ndarray, budget: float
) -> np.ndarray:
    """LLM-Ensemble analogue: greedily take highest-p arms while affordable."""
    p = np.asarray(p, np.float64)
    b = np.asarray(costs, np.float64)
    chosen: List[int] = []
    spent = 0.0
    for arm in np.argsort(-p, kind="stable"):
        if spent + b[arm] <= budget + 1e-15:
            chosen.append(int(arm))
            spent += float(b[arm])
    return np.asarray(chosen, np.int64)


def single_best(p: np.ndarray, costs: np.ndarray, budget: float) -> np.ndarray:
    p = np.asarray(p, np.float64)
    afford = np.flatnonzero(np.asarray(costs, np.float64) <= budget + 1e-15)
    if afford.size == 0:
        return np.zeros(0, np.int64)
    return np.asarray([afford[np.argmax(p[afford])]], np.int64)


def random_subset(costs: np.ndarray, budget: float, rng: np.random.Generator) -> np.ndarray:
    b = np.asarray(costs, np.float64)
    order = rng.permutation(len(b))
    chosen: List[int] = []
    spent = 0.0
    for arm in order:
        if spent + b[arm] <= budget + 1e-15:
            chosen.append(int(arm))
            spent += float(b[arm])
    return np.asarray(chosen, np.int64)
