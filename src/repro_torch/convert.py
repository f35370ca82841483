"""Carry serving state into the port.

ThriftLLM has no weights: the state a router serves from is the workload
(oracle arms' true success probabilities, costs and cluster centres) and
the calibration history the success-probability estimator is built from.
In the JAX package all of it is numpy, so it crosses as plain numpy dicts:

* ``workload``: the ``OracleWorkload`` constructor fields plus its arrays
  ``centers``, ``p_true`` and ``costs``;
* ``history``: ``{"table": (N, L), "emb": (N, d), "assign": (N,)}``, the
  historical correctness table, embeddings and cluster assignment;
* ``arms``: one ``{"name", "arm_index", "seed", "metered"}`` dict per arm.

The ``*_state`` readers take any object with the reference's attribute
names, so ``workload_state(jax_workload)`` and
``workload_state(torch_workload)`` give the same dict; the builders make
the port's objects from those dicts.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np

from repro_torch.core.estimation import SuccessProbEstimator
from repro_torch.data.synth import OracleWorkload
from repro_torch.serving.engine import OracleArm, PoolEngine
from repro_torch.serving.router import ThriftRouter

_WORKLOAD_FIELDS = tuple(f.name for f in dataclasses.fields(OracleWorkload))
_WORKLOAD_ARRAYS = ("centers", "p_true", "costs")


def workload_state(wl) -> Dict:
    """Numpy dict of an ``OracleWorkload`` (either package's)."""
    state = {name: getattr(wl, name) for name in _WORKLOAD_FIELDS}
    state.update({name: np.array(getattr(wl, name)) for name in _WORKLOAD_ARRAYS})
    return state


def workload_from_state(state: Dict) -> OracleWorkload:
    """The port's ``OracleWorkload`` holding exactly ``state``'s arrays."""
    wl = OracleWorkload(**{name: state[name] for name in _WORKLOAD_FIELDS})
    for name in _WORKLOAD_ARRAYS:
        setattr(wl, name, np.array(state[name], np.float64))
    return wl


def arms_state(engine) -> List[Dict]:
    """Per-arm dicts of an oracle ``PoolEngine`` (either package's)."""
    return [
        {"name": a.name, "arm_index": int(a.arm_index), "seed": int(a.seed),
         "metered": bool(a.metered)}
        for a in engine.arms
    ]


def engine_from_state(workload: OracleWorkload, arms: List[Dict]) -> PoolEngine:
    """An oracle ``PoolEngine`` over ``workload`` with the given arms."""
    return PoolEngine([
        OracleArm(a["name"], workload, a["arm_index"], seed=a["seed"],
                  metered=a.get("metered", False))
        for a in arms
    ])


def estimator_from_history(history: Dict, **kwargs) -> SuccessProbEstimator:
    """``SuccessProbEstimator(table, emb, assign, **kwargs)`` from a history
    dict."""
    return SuccessProbEstimator(
        np.asarray(history["table"]), np.asarray(history["emb"]),
        np.asarray(history["assign"]), **kwargs,
    )


def router_from_state(workload: Dict, history: Dict, arms: List[Dict],
                      num_classes: int, **router_kwargs) -> ThriftRouter:
    """The port's ``ThriftRouter`` serving the given state; ``router_kwargs``
    go to the router (``eps``, ``delta``, ``seed``, ``use_kernel``,
    ``jit_waves``, ``device``)."""
    wl = workload_from_state(workload)
    return ThriftRouter(
        engine_from_state(wl, arms), estimator_from_history(history),
        num_classes, **router_kwargs,
    )
