"""The plain reference of ThriftLLM's control plane, in NumPy float64.

From the benchmark's calibration history it works out, on its own:

* the estimator: per-cluster success rates (the mean of the history's
  outcomes) and centroids (the mean embedding), and each query's cluster by
  its nearest centroid (paper Sec. 3.1);
* each plan's wave order (decreasing success rate, clipped to [1e-4,
  1 - 1e-4]) and the log belief weights log(p (K-1) / (1 - p)) (Eq. 4);
* the candidates SurGreedy chooses among (Alg. 2): the best affordable single
  arm, greedy on the closed-form gamma = 1 - prod(1 - p), and greedy on xi,
  the probability that the aggregated answer is right, here computed exactly
  by enumerating every response pattern under the paper's error model (each
  arm right with probability p, else one of the K - 1 wrong classes
  uniformly), where the program estimates it by Monte Carlo;
* the adaptive invocation of each query over its plan (Alg. 3): beliefs
  after each wave, and the Prop. 4 stop — stop before wave t when the
  remaining arms' summed weight plus the runner-up belief cannot reach the
  leader — with the prediction at the stop.

It imports nothing of the program.
"""
from __future__ import annotations

import itertools
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np

P_FLOOR = 1e-4
STOP_MARGIN = 1e-9
TIE_TOL = 1e-6
# The program's device aggregation accumulates beliefs in float32: a stop
# or argmax decision whose float64 margin is within this of its boundary
# may fall either way.
F32_BAND = 1e-4


def clip(p: np.ndarray) -> np.ndarray:
    return np.clip(np.asarray(p, np.float64), P_FLOOR, 1.0 - P_FLOOR)


def log_weight(p: np.ndarray, K: int) -> np.ndarray:
    p = clip(p)
    return np.log(p) + np.log(K - 1.0) - np.log1p(-p)


def empty_belief(p: np.ndarray) -> float:
    pm = float(np.min(clip(p)))
    return math.log(pm) - math.log(2.0) - math.log1p(-pm)


class Estimator:
    """Clusters of the history: rates, centroids and nearest-centroid lookup."""

    def __init__(self, table: np.ndarray, emb: np.ndarray, clusters: np.ndarray):
        self.ids = np.unique(clusters)
        self.p = np.stack([table[clusters == c].mean(axis=0) for c in self.ids])
        self.centroids = np.stack([emb[clusters == c].mean(axis=0) for c in self.ids])

    def lookup(self, emb: np.ndarray) -> np.ndarray:
        d = ((np.asarray(emb, np.float64)[:, None, :] - self.centroids[None]) ** 2).sum(-1)
        return self.ids[np.argmin(d, axis=1)]

    def rates(self, cluster: int) -> np.ndarray:
        return self.p[int(np.flatnonzero(self.ids == cluster)[0])]


def exact_xi(p: np.ndarray, arms: Sequence[int], K: int) -> float:
    """P(the aggregated answer is right) for the set ``arms``: every response
    pattern enumerated, credit 1/m where the right class ties m ways."""
    arms = list(arms)
    if not arms:
        return 1.0 / K
    pc = clip(p)
    w = log_weight(p, K)
    empty = empty_belief(p)
    total = 0.0
    for pattern in itertools.product(range(K), repeat=len(arms)):
        prob = 1.0
        bel = np.full(K, empty)
        seen = np.zeros(K, bool)
        for a, r in zip(arms, pattern):
            prob *= pc[a] if r == 0 else (1.0 - pc[a]) / (K - 1)
            bel[r] = (bel[r] if seen[r] else 0.0) + w[a]
            seen[r] = True
        top = bel >= bel.max() - TIE_TOL
        if top[0]:
            total += prob / top.sum()
    return total


def _greedy(p: np.ndarray, b: np.ndarray, budget: float, value, start: float) -> List[int]:
    """Alg. 1: add the affordable arm of best gain / cost (ties by p / b)."""
    L = p.size
    chosen: List[int] = []
    spent, current = 0.0, start
    while True:
        afford = [a for a in range(L) if a not in chosen and b[a] <= budget - spent + 1e-15]
        if not afford:
            return chosen
        vals = np.asarray([value(chosen + [a]) for a in afford])
        ratios = (vals - current) / b[afford]
        best = ratios.max()
        tied = [i for i in range(len(afford))
                if abs(ratios[i] - best) <= 1e-15 + 1e-9 * abs(best)]
        i = max(tied, key=lambda j: (clip(p)[afford[j]] / b[afford[j]], -j))
        chosen.append(afford[i])
        spent += b[afford[i]]
        current = float(vals[i])


def theta_for(p_star: float, L: int, eps: float = 0.1, delta: float = 0.01) -> int:
    """Monte-Carlo draws the program's planner takes (Alg. 3's theta)."""
    p_star = max(p_star, 1e-6)
    return int(math.ceil((8.0 + 2.0 * eps) / (eps * eps * p_star)
                         * math.log(2.0 * L * L / delta)))


def candidates(p: np.ndarray, b: np.ndarray, budget: float, K: int) -> Dict:
    """SurGreedy's candidates at (p, budget) and their exact xi, and the
    tolerance within which a Monte-Carlo choice between them may differ."""
    afford = np.flatnonzero(b <= budget + 1e-15)
    if afford.size == 0:
        return {"sets": [frozenset()], "xi": [1.0 / K], "tol": 0.0}
    pc = clip(p)
    l_star = int(afford[np.argmax(pc[afford])])
    s1 = _greedy(p, b, budget, lambda s: exact_xi(p, s, K), 1.0 / K)
    s2 = _greedy(p, b, budget, lambda s: 1.0 - float(np.prod(1.0 - pc[s])), 0.0)
    sets = [frozenset([l_star]), frozenset(s1), frozenset(s2)]
    theta = theta_for(float(pc[afford].max()), p.size)
    return {"sets": sets, "xi": [exact_xi(p, sorted(s), K) for s in sets],
            "tol": 5.0 * math.sqrt(0.25 / theta)}


def plan_ok(p: np.ndarray, b: np.ndarray, budget: float, K: int,
            order: Sequence[int]) -> Tuple[bool, str]:
    """Whether a plan's wave order is one SurGreedy may serve at (p, budget)."""
    order = [int(a) for a in order if a >= 0]
    if len(set(order)) != len(order):
        return False, "an arm twice in one plan"
    if float(np.sum(b[order])) > budget + 1e-15:
        return False, "plan over budget"
    pc = clip(p)
    if order != sorted(order, key=lambda a: -pc[a]):
        return False, "waves not in decreasing success rate"
    cand = candidates(p, b, budget, K)
    chosen = frozenset(order)
    if chosen not in cand["sets"]:
        return False, f"set {sorted(chosen)} is none of {[sorted(s) for s in cand['sets']]}"
    if exact_xi(p, order, K) < max(cand["xi"]) - cand["tol"]:
        return False, "a candidate of clearly higher xi was passed over"
    return True, ""


def invoke(p: np.ndarray, K: int, order: Sequence[int], answers: Dict[int, int]):
    """Alg. 3 over ``order`` with the arms' ``answers``: ``(stop wave,
    prediction, ambiguous)``; ``ambiguous`` when a decision the reference
    took lies within :data:`F32_BAND` of its boundary."""
    order = [int(a) for a in order if a >= 0]
    w = log_weight(p, K)
    bel = np.full(K, empty_belief(p))
    seen = np.zeros(K, bool)
    ambiguous = False
    t = 0
    while t < len(order):
        top = np.sort(bel)[::-1]
        h1, h2 = top[0], top[1]
        rest = float(np.sum(w[order[t:]]))
        margin = rest + h2 - (h1 - STOP_MARGIN)
        ambiguous |= abs(margin) <= F32_BAND * max(1.0, abs(h1))
        if not margin > 0:
            break
        r = answers.get(order[t], -1)
        if not 0 <= r < K:
            return t, -1, ambiguous
        bel[r] = (bel[r] if seen[r] else 0.0) + w[order[t]]
        seen[r] = True
        t += 1
    top = np.sort(bel)[::-1]
    ambiguous |= (top[0] - top[1]) <= F32_BAND * max(1.0, abs(top[0]))
    return t, int(np.argmax(bel)), ambiguous
