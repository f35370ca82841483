"""Synthetic classification workload generator.

Mirrors the paper's experimental setting (Section 6) without external
datasets: a workload has query *classes* (semantic clusters) and a pool of
arms whose ground-truth success probability varies per class — cheap arms
excel on some clusters, expensive arms dominate on average, exactly the
regime where budget-aware ensemble selection pays off.

:class:`OracleWorkload` — arms are Bernoulli oracles with per-class
success probs (responses follow Eq. 1's error model).

:func:`make_token_task` — token sequences whose final token is the class id,
for the model-backed ``LMArm`` pool.

Numpy generators throughout, copied from ``repro/data/synth.py`` so the
port draws the same workloads and tasks bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass
class OracleWorkload:
    """Synthetic query-class workload with Bernoulli arms."""

    num_classes: int                # K: label-space size
    num_clusters: int               # query classes
    num_arms: int
    emb_dim: int = 32
    seed: int = 0
    skill_spread: float = 0.25      # how much per-cluster skill varies
    base_low: float = 0.45
    base_high: float = 0.95

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self.centers = rng.normal(0, 1, (self.num_clusters, self.emb_dim))
        self.centers /= np.linalg.norm(self.centers, axis=1, keepdims=True)
        # arm quality grows with index (stronger = pricier, Table 4 regime)
        base = np.linspace(self.base_low, self.base_high, self.num_arms)
        skew = rng.normal(0, self.skill_spread, (self.num_clusters, self.num_arms))
        self.p_true = np.clip(base[None, :] + skew, 0.05, 0.995)
        # FLOP-proportional pricing with a spread, mirroring Table 4
        flops = np.geomspace(1.0, 600.0, self.num_arms)
        self.costs = flops * 3.5e-7 * rng.uniform(0.8, 1.25, self.num_arms)

    # ------------------------------------------------------------------
    def sample_queries(
        self, n: int, rng: np.random.Generator
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Returns (cluster_ids (n,), embeddings (n,d), labels (n,))."""
        cid = rng.integers(self.num_clusters, size=n)
        emb = self.centers[cid] + rng.normal(0, 0.08, (n, self.emb_dim))
        labels = rng.integers(self.num_classes, size=n)
        return cid, emb, labels

    def drift_arms(self, arms, p, clusters=None) -> np.ndarray:
        """Shift arms' *true* per-cluster accuracy mid-stream — the
        online-feedback scenario (a provider silently swaps or degrades a
        model; FrugalGPT/MetaLLM's drift setting). Sets
        ``p_true[clusters, arm] = p`` for each arm in ``arms`` (all
        clusters when ``clusters`` is None) and returns the previous
        values, so a benchmark can restore them."""
        arms = np.atleast_1d(np.asarray(arms, np.int64))
        rows = (
            np.arange(self.num_clusters)
            if clusters is None
            else np.atleast_1d(np.asarray(clusters, np.int64))
        )
        old = self.p_true[np.ix_(rows, arms)].copy()
        self.p_true[np.ix_(rows, arms)] = np.clip(p, 0.0, 1.0)
        return old

    def invoke(
        self, arm: int, cluster: int, label: int, rng: np.random.Generator
    ) -> int:
        """Arm response under the paper's error model (Eq. 1)."""
        if rng.random() < self.p_true[cluster, arm]:
            return int(label)
        wrong = rng.integers(self.num_classes - 1)
        return int((label + 1 + wrong) % self.num_classes)

    def invoke_batch(
        self,
        arm: int,
        clusters: np.ndarray,
        labels: np.ndarray,
        rng: np.random.Generator,
    ) -> np.ndarray:
        """Vectorized :meth:`invoke` over (n,) clusters/labels — same error
        model, one rng draw per query instead of a Python loop (the serving
        throughput path; draw order differs from the scalar loop)."""
        return self.invoke_assigned(
            np.full(np.asarray(clusters).shape, arm, np.int64), clusters, labels, rng
        )

    def invoke_assigned(
        self,
        arms: np.ndarray,
        clusters: np.ndarray,
        labels: np.ndarray,
        rng: np.random.Generator,
    ) -> np.ndarray:
        """Heterogeneous-arm vectorized invocation: query i is served by
        ``arms[i]``. One rng draw per query regardless of how many distinct
        arms appear — the serving wavefront's one-call-per-wave fast path."""
        arms = np.asarray(arms, np.int64)
        clusters = np.asarray(clusters, np.int64)
        labels = np.asarray(labels, np.int64)
        p = self.p_true[clusters, arms]
        u = rng.random((2, clusters.size))       # one draw for hit + wrong-class
        hit = u[0] < p
        wrong = np.minimum(
            (u[1] * (self.num_classes - 1)).astype(np.int64), self.num_classes - 2
        )
        return np.where(hit, labels, (labels + 1 + wrong) % self.num_classes)

    def response_table(
        self, n: int, seed: int = 1
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Historical matrix T (n, L) of correctness booleans + embeddings +
        cluster ids (Section 3.1 input)."""
        rng = np.random.default_rng(seed)
        cid, emb, labels = self.sample_queries(n, rng)
        T = np.zeros((n, self.num_arms), np.float64)
        for i in range(n):
            for a in range(self.num_arms):
                T[i, a] = self.invoke(a, cid[i], labels[i], rng) == labels[i]
        return T, emb, cid


# ---------------------------------------------------------------------------
# Token-level task for real-model arms
# ---------------------------------------------------------------------------


def make_token_task(
    num_classes: int,
    seq_len: int,
    vocab: int,
    n: int,
    seed: int = 0,
    noise: float = 0.0,
) -> Dict[str, np.ndarray]:
    """Sequences whose final token must be the class id.

    The class is determined by which `signature` token appears most often in
    the sequence body — learnable by a tiny LM, with capacity controlling
    attainable accuracy (bigger arms really are better).
    """
    rng = np.random.default_rng(seed)
    if vocab <= num_classes + 8:
        raise ValueError(f"vocab {vocab} must exceed num_classes + 8 = {num_classes + 8}")
    sig_tokens = np.arange(num_classes) + 4          # reserved signature ids
    body_len = seq_len - 2
    tokens = rng.integers(num_classes + 4, vocab, size=(n, seq_len))
    labels = rng.integers(num_classes, size=n)
    for i in range(n):
        # plant signature occurrences of the true class (+ distractors)
        k_true = rng.integers(4, max(5, body_len // 4))
        pos = rng.choice(body_len, size=k_true, replace=False)
        tokens[i, pos] = sig_tokens[labels[i]]
        distract = rng.integers(num_classes)
        if distract != labels[i]:
            k_d = int(rng.integers(1, max(2, k_true - 1)))   # strictly fewer
            free = np.setdiff1d(np.arange(body_len), pos)    # never overwrite
            if free.size:
                pos_d = rng.choice(free, size=min(k_d, free.size), replace=False)
                tokens[i, pos_d] = sig_tokens[distract]
    tokens[:, -2] = 2                                 # "answer:" marker
    tokens[:, -1] = sig_tokens[labels]                # answer token
    if noise > 0:
        flip = rng.random(n) < noise
        tokens[flip, -1] = sig_tokens[rng.integers(num_classes, size=flip.sum())]
    return {
        "tokens": tokens.astype(np.int32),
        "labels": labels.astype(np.int32),
        "class_token_ids": sig_tokens.astype(np.int32),
    }
