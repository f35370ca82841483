"""Core datatypes for the ThriftLLM ensemble-selection framework (numpy;
the PyTorch port's copy of ``repro/core/types.py``).

The control plane works on small dense arrays:
  * ``p``  -- (L,) success probabilities of the candidate pool on a query class
  * ``b``  -- (L,) per-query costs of the candidates (USD or FLOP-derived)
  * ``K``  -- number of classes of the classification query class
  * ``B``  -- budget per query (same unit as ``b``)

Arms are *operators* in the paper's DB framing: an arm wraps any callable
model or a simulated oracle in tests).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping, Optional, Sequence

import numpy as np

# Numerical floor used when converting success probabilities to belief
# weights; keeps log(p(K-1)/(1-p)) finite for p in {0, 1}.
P_FLOOR = 1e-4


@dataclasses.dataclass(frozen=True)
class Arm:
    """One candidate LLM operator in the pool.

    Attributes:
      name: human-readable identifier (e.g. ``"smollm-135m"``).
      cost: per-query cost ``b_i``. For real models this is derived from
        FLOPs/token x $/FLOP so that stronger => pricier, mirroring the
        paper's Table 4 regime; a USD override may be supplied.
      invoke: optional callable ``(query) -> class_id`` used by the adaptive
        invocation loop (Algorithm 3). ``None`` for pure selection math.
      meta: free-form metadata (arch id, flops/token, provider, ...).
    """

    name: str
    cost: float
    invoke: Optional[Callable[[Any], int]] = None
    meta: Mapping[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass(frozen=True)
class QueryClass:
    """A query class Q: semantically-similar queries sharing success probs.

    Attributes:
      probs: (L,) estimated success probability of each arm on this class.
      num_classes: K, the label-space size of the classification task.
      lo / hi: optional (L,) confidence-interval bounds around ``probs``
        (Section 4.4); equal to ``probs`` when intervals are not tracked.
      meta: e.g. cluster id, centroid, sample count.
    """

    probs: np.ndarray
    num_classes: int
    lo: Optional[np.ndarray] = None
    hi: Optional[np.ndarray] = None
    meta: Mapping[str, Any] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        object.__setattr__(self, "probs", np.asarray(self.probs, np.float64))
        if self.lo is None:
            object.__setattr__(self, "lo", self.probs)
        if self.hi is None:
            object.__setattr__(self, "hi", self.probs)


@dataclasses.dataclass
class SelectionResult:
    """Output of SurGreedyLLM / ThriftLLM selection for one query class."""

    chosen: np.ndarray                 # (m,) int indices into the pool, ranked
    xi_est: float                      # estimated correctness prob of chosen
    cost: float                        # sum of costs of chosen
    budget: float
    # Diagnostics for the Theorem 3 instance-dependent bound:
    s1: Optional[np.ndarray] = None    # greedy-on-xi set
    s2: Optional[np.ndarray] = None    # greedy-on-gamma set
    l_star: Optional[int] = None       # best affordable single arm
    xi_s1: float = 0.0
    xi_s2: float = 0.0
    p_star: float = 0.0
    gamma_s2: float = 0.0

    @property
    def approx_ratio_bound(self) -> float:
        """Instance-dependent factor from Theorem 3 (excluding the 1-1/sqrt(e))."""
        denom = max(self.gamma_s2, self.p_star)
        if denom <= 0:
            return 0.0
        return max(self.xi_s1, self.xi_s2, self.p_star) / denom


@dataclasses.dataclass
class InvocationResult:
    """Output of the adaptive invocation loop (Algorithm 3, lines 3-11)."""

    prediction: int
    used: np.ndarray                   # indices actually invoked, in order
    responses: np.ndarray              # their responses
    cost: float                        # realized cost (<= planned cost)
    planned_cost: float                # cost of the full selected set S*
    log_beliefs: np.ndarray            # (K,) final log-belief per class


def clip_probs(p: np.ndarray, floor: float = P_FLOOR) -> np.ndarray:
    """Clip probabilities into [floor, 1-floor] for numerically-safe logits."""
    return np.clip(np.asarray(p, np.float64), floor, 1.0 - floor)


def pool_cost(b: np.ndarray, idx: Sequence[int]) -> float:
    return float(np.sum(np.asarray(b, np.float64)[np.asarray(idx, np.int64)])) if len(idx) else 0.0
