"""Carry serving state into the port.

ThriftLLM has no weights: the state a router serves from is the workload
(oracle arms' true success probabilities, costs and cluster centres) and
the calibration history the success-probability estimator is built from.
In the JAX package all of it is numpy, so it crosses as plain numpy dicts:

* ``workload``: the ``OracleWorkload`` constructor fields plus its arrays
  ``centers``, ``p_true`` and ``costs``;
* ``history``: ``{"table": (N, L), "emb": (N, d), "assign": (N,)}``, the
  historical correctness table, embeddings and cluster assignment;
* ``arms``: one ``{"name", "arm_index", "seed", "metered"}`` dict per arm;
* ``fault_policy``: a ``FaultPolicy``'s shape, seed, epoch and per-arm
  timeout / error / degrade rates.

The ``*_state`` readers take any object with the reference's attribute
names, so ``workload_state(jax_workload)`` and
``workload_state(torch_workload)`` give the same dict; the builders make
the port's objects from those dicts.

Model-backed arms carry weights. Those cross as the JAX parameter pytree
in nested numpy dicts — ``{"embed": {"tok"}, "final_norm", ["head":
{"w"}], "seg{i}": {"u{j}": {name: (repeats, ...)}}}``, MoE expert stacks
``(repeats, E, D, F)`` and QKV biases included — which
:func:`lm_params_from_jax` unstacks into the port's per-layer layout, in
the JAX layer order; ``lm_arm_state`` / ``lm_arm_from_state`` carry a whole
JAX ``LMArm`` (config fields, weights, class tokens, pricing inputs).
Training state crosses the same way: :func:`train_state_from_jax` takes
the JAX parameter pytree and AdamW state (``m``, ``v``, ``master``,
``step``, ``residuals`` under a codec) and gives the port's per-layer
parameters and its optimizer state keyed by parameter name, so both
packages train from the same numbers. Decode caches cross as the JAX
cache pytree in numpy (``{"pos", "ring", "segs": [{"u{j}": {leaf:
(repeats, B, T, ...)}}]}``): :func:`cache_from_jax` unstacks it into the
port's per-layer cache (:meth:`repro_torch.models.LM.prefill`) and
:func:`cache_to_jax` stacks the port's back, so a decode can start from a
JAX-made cache and the two be compared leaf by leaf.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

from repro_torch.core.estimation import SuccessProbEstimator
from repro_torch.data.synth import OracleWorkload
from repro_torch.distributed.fault import FaultPolicy
from repro_torch.models import LM, ModelConfig, named_params, unstack_params
from repro_torch.serving.engine import LMArm, OracleArm, PoolEngine
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


def fault_policy_state(policy) -> Dict:
    """Numpy dict of a ``FaultPolicy`` (either package's)."""
    return {
        "num_arms": int(policy.num_arms), "num_classes": int(policy.num_classes),
        "seed": int(policy.seed), "epoch": int(policy.epoch),
        "timeout": np.array(policy._timeout, np.float64),
        "error": np.array(policy._error, np.float64),
        "degrade": np.array(policy._degrade, np.float64),
    }


def fault_policy_from_state(state: Dict) -> FaultPolicy:
    """The port's ``FaultPolicy`` drawing exactly as ``state``'s does."""
    policy = FaultPolicy(state["num_arms"], state["num_classes"], seed=state["seed"])
    policy.epoch = int(state["epoch"])
    for arm in range(policy.num_arms):
        policy.set_arm(arm, timeout=state["timeout"][arm], error=state["error"][arm],
                       degrade=state["degrade"][arm])
    return policy


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


def _to_torch(tree):
    """Nested dicts of arrays -> nested dicts of CPU tensors (bf16 arrays,
    which numpy holds as ``ml_dtypes.bfloat16``, cross bit for bit)."""
    if isinstance(tree, dict):
        return {k: _to_torch(v) for k, v in tree.items()}
    arr = np.asarray(tree)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.uint16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _to_numpy(tree):
    if isinstance(tree, dict):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def lm_params_from_jax(params_np: Dict, cfg) -> Dict:
    """The port's per-layer parameter layout (CPU tensors) from the JAX
    parameter pytree given as nested numpy dicts."""
    cfg.refuse_mla("the JAX conversion")
    return unstack_params(_to_torch(params_np), cfg)


def lm_from_jax(params_np: Dict, cfg, device="cuda") -> LM:
    """The port's ``LM`` of ``cfg`` holding the JAX parameters, on ``device``."""
    return LM(cfg, device=device, params=lm_params_from_jax(params_np, cfg))


def lm_arm_state(arm) -> Dict:
    """Numpy dict of a JAX ``LMArm``: its name, config fields, parameter
    pytree, class tokens, ``tokens_per_query`` and ``metered``."""
    return {
        "name": arm.name,
        "cfg": dataclasses.asdict(arm.model.cfg),
        "params": _to_numpy(arm.params),
        "class_token_ids": np.array(arm.class_token_ids),
        "tokens_per_query": int(arm.tokens_per_query),
        "metered": bool(arm.metered),
    }


def lm_arm_from_state(state: Dict, device="cuda") -> LMArm:
    """The port's ``LMArm`` answering as the JAX arm ``state`` came from."""
    cfg = ModelConfig(**state["cfg"])
    return LMArm(
        state["name"], lm_from_jax(state["params"], cfg, device),
        np.asarray(state["class_token_ids"]), tokens_per_query=state["tokens_per_query"],
        metered=state["metered"],
    )


def train_state_from_jax(params_np: Dict, opt_np: Dict, cfg) -> tuple:
    """``(params, opt_state)`` of the port from a JAX ``init_train_state``
    (or a JAX train step's output) given as nested numpy dicts: the
    per-layer parameter layout :class:`LM` takes and the optimizer state
    keyed by ``LM.named_parameters()`` names, all CPU tensors."""
    named = lambda tree: named_params(lm_params_from_jax(tree, cfg))
    opt = {k: named(opt_np[k]) for k in ("m", "v", "master")}
    opt["step"] = torch.tensor(int(np.asarray(opt_np["step"])), dtype=torch.int32)
    if "residuals" in opt_np:
        opt["residuals"] = named(opt_np["residuals"])
    return lm_params_from_jax(params_np, cfg), opt


def cache_from_jax(cache_np: Dict, cfg, device="cuda") -> Dict:
    """The port's decode cache on ``device`` from a JAX cache given as
    nested numpy (``LM.init_cache`` or ``LM.prefill`` of the JAX package):
    each segment's stacked leaves split into its layers, in the JAX layer
    order; ``pos`` a Python int, ``ring`` an int32 tensor or None."""
    cfg.refuse_mla("the JAX conversion")
    layers = []
    for si, (unit, repeats) in enumerate(cfg.segments()):
        seg = cache_np["segs"][si]
        for r in range(repeats):
            for j in range(len(unit)):
                leaves = _to_torch({k: np.asarray(v)[r] for k, v in seg[f"u{j}"].items()})
                layers.append({k: t.to(device) for k, t in leaves.items()})
    ring = cache_np["ring"]
    return {"pos": int(np.asarray(cache_np["pos"])), "layers": layers,
            "ring": None if ring is None else _to_torch(ring).to(torch.int32).to(device)}


def _leaf_to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:                 # numpy has no bf16: jax's ml_dtypes does
        import ml_dtypes

        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def cache_to_jax(cache: Dict, cfg) -> Dict:
    """The JAX cache layout, in numpy, of the port's decode cache: each
    segment's layers stacked per leaf (``(repeats, B, T, ...)``), ``pos``
    an int32 scalar."""
    cfg.refuse_mla("the JAX conversion")
    segs, i = [], 0
    for unit, repeats in cfg.segments():
        seg = {}
        for j in range(len(unit)):
            names = cache["layers"][i + j].keys()
            seg[f"u{j}"] = {k: np.stack([_leaf_to_numpy(cache["layers"][i + r * len(unit) + j][k])
                                         for r in range(repeats)]) for k in names}
        segs.append(seg)
        i += repeats * len(unit)
    ring = cache["ring"]
    return {"pos": np.int32(cache["pos"]), "segs": segs,
            "ring": None if ring is None else _leaf_to_numpy(ring)}
