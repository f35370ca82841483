"""The one generator of every traffic mix.

A mix is a data file, ``thriftbench/traffic/<mix>.json``; this module reads
its parameters and draws everything from the run's seed:

* queries: :func:`~thriftbench.traffic.synth.make_token_task` rows
  (``seq_len`` tokens at ``vocab``), each assigned a cluster; the filler
  tokens of a row are folded into its cluster's band of the vocabulary, so
  the bincount embedding maps the query to its cluster. Clusters, and budget
  tiers, come in equal counts, shuffled, so every seed carries the same work
  in another order.
* budgets: the mix's ``budget`` names its kind, a module
  ``budgets/<kind>.py`` whose ``levels(prices, spec)`` gives the distinct
  budgets over the pool's prices; queries draw them in equal counts.
* arrivals: the mix's ``arrivals`` names its law, a module
  ``arrivals/<law>.py`` with ``ahead`` (the queries a stretch draws ahead)
  and ``drive`` (the stretch itself, with its end-to-end readings).
* the calibration history of the pool: per (cluster, arm) success rates
  drawn so that pricier arms are more accurate on average, and a table of
  Bernoulli outcomes over ``history_per_cluster`` rows a cluster. It is the
  deployment's, drawn from the configuration's ``history_seed`` and not
  from the run's: the plans follow from it, and every seed serves the same
  plans.

Streams (``history``, ``warmup``, ``profile``, ``window``) draw from
independent generators of one seed.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path
from types import ModuleType
from typing import Dict, Optional

import numpy as np

from .synth import make_token_task, token_embed

HERE = Path(__file__).resolve().parent
STREAMS = {"history": 0, "warmup": 1, "profile": 2, "window": 3, "check": 4}


def rng_for(seed: int, stream: str, sub: int = 0) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(int(seed),
                                                        spawn_key=(STREAMS[stream], sub)))


def _balanced(n: int, k: int, rng: np.random.Generator) -> np.ndarray:
    """``n`` labels in 0..k-1 in equal counts (the first n % k one more), shuffled."""
    return rng.permutation(np.arange(n) % k)


def band_of(cluster: np.ndarray, lo: int, vocab: int, n_clusters: int):
    """(first id, width) of each cluster's band of ids in ``[lo, vocab)``."""
    width = (vocab - lo) // n_clusters
    return lo + np.asarray(cluster) * width, width


def make_queries(pool: Dict, mix: Dict, seed: int, n: int, stream: str,
                 sub: int = 0, clusters: Optional[np.ndarray] = None) -> Dict[str, np.ndarray]:
    """``n`` queries of ``stream``: tokens (n, seq_len) int32, emb (n, vocab)
    f64, clusters (n,), budgets (n,) USD, labels (n,)."""
    K, C = pool["num_classes"], pool["num_clusters"]
    seq_len, vocab = mix["seq_len"], mix["vocab"]
    rng = rng_for(seed, stream, sub)
    task = make_token_task(K, seq_len, vocab, n, seed=int(rng.integers(1 << 62)))
    tokens = task["tokens"].astype(np.int64)
    if clusters is None:
        clusters = _balanced(n, C, rng)
    lo = K + 4
    start, width = band_of(clusters, lo, vocab, C)
    body = tokens[:, :-2]
    filler = body >= lo
    folded = start[:, None] + (body - lo) % width
    body[filler] = folded[filler]
    tokens = tokens.astype(np.int32)
    return {"tokens": tokens, "emb": token_embed(tokens, vocab),
            "clusters": np.asarray(clusters, np.int64),
            "budgets": make_budgets(pool, mix, n, rng),
            "labels": task["labels"].astype(np.int64),
            "class_token_ids": task["class_token_ids"]}


def law(family: str, name: str) -> ModuleType:
    """The module ``<family>/<name>.py`` beside this one: an arrival law
    (``arrivals``) or a budget kind (``budgets``)."""
    path = HERE / family / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"unknown {family} {name!r}: no {path}")
    spec = importlib.util.spec_from_file_location(f"thriftbench_{family}_{path.stem}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def arrivals(mix: Dict) -> ModuleType:
    return law("arrivals", mix["arrivals"])


def budget_levels(pool: Dict, mix: Dict) -> np.ndarray:
    """The distinct budgets of a mix over this pool's prices."""
    prices = np.asarray([a["price_usd"] for a in pool["arms"]], np.float64)
    return law("budgets", mix["budget"]["kind"]).levels(prices, mix["budget"])


def make_budgets(pool: Dict, mix: Dict, n: int, rng: np.random.Generator) -> np.ndarray:
    levels = budget_levels(pool, mix)
    return levels[_balanced(n, levels.size, rng)]


def make_history(pool: Dict, mix: Dict) -> Dict[str, np.ndarray]:
    """The calibration history: ``table`` (N, L) 0/1 outcomes, ``emb`` (N,
    vocab), ``clusters`` (N,), and ``p_true`` (C, L), the rates drawn."""
    seed = int(pool["history_seed"])
    C = pool["num_clusters"]
    L = len(pool["arms"])
    per = int(pool["history_per_cluster"])
    rng = rng_for(seed, "history", 1)
    prices = np.asarray([a["price_usd"] for a in pool["arms"]], np.float64)
    rank = np.argsort(np.argsort(prices))                 # 0 = cheapest
    lo, hi = pool["accuracy_range"]
    base = np.linspace(lo, hi, L)[rank]
    p_true = np.clip(base[None, :] + rng.normal(0.0, pool["accuracy_spread"], (C, L)),
                     0.05, 0.98)
    clusters = np.repeat(np.arange(C), per)
    q = make_queries(pool, mix, seed, C * per, "history", clusters=clusters)
    table = (rng.random((C * per, L)) < p_true[clusters]).astype(np.float64)
    return {"table": table, "emb": q["emb"], "clusters": clusters, "p_true": p_true}
