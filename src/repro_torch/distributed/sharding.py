"""Logical-axis sharding rules (MaxText-style) for every architecture, and
the replica plane's device placement (the port of
``repro/distributed/sharding.py``).

Model code names *logical* axes (``constrain(h, "batch", "seq",
"embed")``) and parameter leaves carry name-derived logical specs. An
:class:`AxisRules` binding maps logical axes onto mesh axes with
divisibility checks — non-divisible dims fall back to replication, which
is what makes one rule-set serve all 10 architectures (36-head starcoder2
simply replicates heads and keeps the flat-feature TP sharding).

A spec is a tuple with one entry per dim — ``None``, one mesh-axis name,
or a tuple of names — the counterpart of ``jax.sharding.PartitionSpec``;
:meth:`AxisRules.sharding_for` returns a :class:`Sharding` (mesh and spec)
whose ``shard_shape`` is a device's block of a global shape. A mesh is the
port's :class:`Mesh` (named axes and their sizes, with or without
devices: the counterpart of ``jax.sharding.Mesh`` and ``AbstractMesh``)
or a ``torch.distributed.device_mesh.DeviceMesh`` with named dims.

The port's trees are per layer (:func:`repro_torch.models.init.unstack_params`)
where the JAX package stacks each segment's layers: a leaf's spec here is
the JAX stacked leaf's spec without its leading (replicated) stacked dim.
Optimizer trees are keyed by ``LM.named_parameters()`` names
(``layers.<i>.params.<name>``; the untied head is ``head``, JAX's
``head/w``).

``constrain`` and ``constrain_params`` return their argument unchanged,
with rules or without: they are where the JAX package hands a layout to
XLA's SPMD partitioner, and a PyTorch program has no partitioner to take
the annotation. Expert parallelism is explicit instead
(:func:`repro_torch.models.moe.moe_mlp_ep` over a ``DeviceMesh``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Callable, Dict, Mapping, Optional, Sequence, Tuple, Union

import torch

LogicalAxes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[LogicalAxes, ...]

# Default logical -> mesh-axis mapping. "fsdp" shards parameter rows over the
# data axis (ZeRO-3 style); "tp"/"heads"/"vocab"/"ff" shard over model.
DEFAULT_RULES: Dict[str, LogicalAxes] = {
    "batch": ("pod", "data"),
    "seq": None,
    "embed": None,
    "vocab": "model",
    "heads": "model",
    "ff": "model",
    "tp": "model",
    "experts": "model",
    "fsdp": "data",
    # decode KV-cache time dimension: sharding it over 'model' divides the
    # dominant decode memory by the TP degree regardless of KV-head count
    # (GQA head counts rarely divide 16; the 32k time axis always does).
    "kv": "model",
    # ZeRO-3 output-dim sharding: weight matrices shard their OUTPUT dim
    # over (data, model) jointly, leaving contraction dims whole. Enabled
    # per arch via rules override {"zero3": True}.
    "fsdp_tp": ("data", "model"),
    "zero3": False,
}

# 2-D weight leaves that flip to (None, "fsdp_tp") under zero3.
ZERO3_LEAVES = {
    "wq", "wk", "wv", "wo", "wg", "wu", "wd", "w_in", "w_out",
    "wy", "wx", "wr", "wi",
}


@dataclasses.dataclass(frozen=True)
class Mesh:
    """Named mesh axes and their sizes; ``devices`` (row-major over the
    axes) where the mesh has them, None for a layout alone. ``shape``
    maps each axis name to its size, as ``jax.sharding.Mesh.shape``."""

    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]
    devices: Optional[Tuple[torch.device, ...]] = None

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"{self.axis_names} names for {self.axis_sizes} sizes")
        if self.devices is not None and len(self.devices) != math.prod(self.axis_sizes):
            raise ValueError(f"{len(self.devices)} devices for a {self.axis_sizes} mesh")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size of a port :class:`Mesh` (``.shape`` a mapping) or
    of a ``DeviceMesh`` (``.shape`` a tuple, the names in
    ``.mesh_dim_names``)."""
    if isinstance(mesh.shape, Mapping):
        return dict(mesh.shape)
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None:
        raise ValueError("a DeviceMesh needs mesh_dim_names for the sharding rules")
    return dict(zip(names, mesh.shape))


@dataclasses.dataclass(frozen=True)
class Sharding:
    """A mesh and a spec: the counterpart of ``jax.sharding.NamedSharding``."""

    mesh: Any
    spec: Spec

    def shard_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        """One device's block of ``global_shape`` (spec entries past its
        end replicate)."""
        sizes = mesh_shape(self.mesh)
        out = []
        for i, dim in enumerate(global_shape):
            entry = self.spec[i] if i < len(self.spec) else None
            axes = () if entry is None else ((entry,) if isinstance(entry, str) else entry)
            n = math.prod(sizes[a] for a in axes)
            if dim % n:
                raise ValueError(f"dim {i} of {tuple(global_shape)} does not divide by {n}")
            out.append(dim // n)
        return tuple(out)


@dataclasses.dataclass
class AxisRules:
    mesh: Any
    rules: Dict[str, LogicalAxes] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        merged = dict(DEFAULT_RULES)
        merged.update(self.rules)
        self.rules = merged
        self.sizes = mesh_shape(self.mesh)     # name -> size, read once

    def mesh_axes(self, logical: Optional[str]) -> Tuple[str, ...]:
        if logical is None:
            return ()
        ax = self.rules.get(logical)
        if ax is None:
            return ()
        axes = (ax,) if isinstance(ax, str) else tuple(ax)
        return tuple(a for a in axes if a in self.sizes)

    def axis_size(self, axes: Tuple[str, ...]) -> int:
        return math.prod(self.sizes[a] for a in axes) if axes else 1

    def spec_for(self, shape: Sequence[int], logical: Sequence[Optional[str]]) -> Spec:
        """Resolve logical dims to a spec with divisibility checks and no
        mesh-axis reuse."""
        used: set = set()
        out = []
        for dim, name in zip(shape, logical):
            axes = self.mesh_axes(name)
            if axes and not (set(axes) & used) and dim % self.axis_size(axes) == 0:
                out.append(axes if len(axes) > 1 else axes[0])
                used.update(axes)
            else:
                out.append(None)
        return tuple(out)

    def sharding_for(self, shape: Sequence[int], logical: Sequence[Optional[str]]) -> Sharding:
        return Sharding(self.mesh, self.spec_for(shape, logical))


_ACTIVE: Optional[AxisRules] = None


@contextlib.contextmanager
def use_rules(rules: Optional[AxisRules]):
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = rules
    try:
        yield rules
    finally:
        _ACTIVE = prev


def active_rules() -> Optional[AxisRules]:
    return _ACTIVE


def constrain(x: torch.Tensor, *logical: Optional[str]) -> torch.Tensor:
    """The activation-sharding annotation: ``x`` itself, with rules or
    without (no SPMD partitioner takes it here)."""
    return x


# ---------------------------------------------------------------------------
# Parameter / cache / batch specs by leaf name
# ---------------------------------------------------------------------------

# leaf-name -> logical axes of its dims (one layer's)
PARAM_LOGICAL: Dict[str, Tuple[Optional[str], ...]] = {
    "tok": ("vocab", "fsdp"),
    "w": ("fsdp", "vocab"),          # untied head
    "final_norm": (None,),
    "ln": (None,), "ln1": (None,), "ln2": (None,),
    "wq": ("fsdp", "tp"), "wk": ("fsdp", "tp"), "wv": ("fsdp", "tp"),
    "wo": ("tp", "fsdp"),
    "bq": ("tp",), "bk": ("tp",), "bv": ("tp",),
    "wg": ("fsdp", "tp"), "wu": ("fsdp", "tp"), "wd": ("tp", "fsdp"),
    "router": ("fsdp", None),
    "ewg": ("experts", "fsdp", None),
    "ewu": ("experts", "fsdp", None),
    "ewd": ("experts", None, "fsdp"),
    "w_in": ("fsdp", "tp"),
    "conv_w": ("tp", None), "conv_b": ("tp",),
    "w_x": ("tp", None), "w_dt": (None, "tp"), "b_dt": ("tp",),
    "a_log": ("tp", None), "d_skip": ("tp",),
    "w_out": ("tp", "fsdp"),
    "wy": ("fsdp", "tp"), "wx": ("fsdp", "tp"),
    "wr": ("fsdp", "tp"), "wi": ("fsdp", "tp"),
    "br": ("tp",), "bi": ("tp",), "lam": ("tp",),
}

CACHE_LOGICAL: Dict[str, Tuple[Optional[str], ...]] = {
    "k": ("batch", "kv", "heads", None),   # heads dropped if 'model' taken by kv
    "v": ("batch", "kv", "heads", None),
    "k_scale": ("batch", "kv", "heads", None),   # int8-KV scales
    "v_scale": ("batch", "kv", "heads", None),
    "conv": ("batch", None, "tp"),
    "h": ("batch", "tp", None),      # ssm state (B, Din, N); rec uses 2 dims
}


def _map_with_path(fn: Callable, tree: Any, path: Tuple = ()) -> Any:
    """``fn(path, leaf)`` over the leaves of nested dicts, lists and tuples
    (a path holds dict keys and list indices); None stays None, as an
    empty subtree."""
    if isinstance(tree, dict):
        return {k: _map_with_path(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_with_path(fn, v, path + (i,)) for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def _leaf_name(path) -> str:
    """The JAX leaf name of a path: its last dict key, the last part of a
    ``named_parameters()`` name; the untied ``head`` is JAX's ``w``."""
    for entry in reversed(path):
        if isinstance(entry, str):
            name = entry.rsplit(".", 1)[-1]
            return "w" if name == "head" else name
    return ""


def _shape(leaf) -> Tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def param_specs(shapes_tree: Any, rules: AxisRules) -> Any:
    """Tree of :class:`Sharding` for a parameter (or optimizer) tree."""
    zero3 = bool(rules.rules.get("zero3"))
    replicated_ = Sharding(rules.mesh, ())

    def spec(path, leaf):
        name = _leaf_name(path)
        logical = PARAM_LOGICAL.get(name)
        shape = _shape(leaf)
        if logical is None or len(shape) != len(logical):
            return replicated_
        if zero3 and name in ZERO3_LEAVES and len(logical) == 2:
            logical = (None, "fsdp_tp")
        return rules.sharding_for(shape, logical)

    return _map_with_path(spec, shapes_tree)


def cache_specs(cache_tree: Any, rules: AxisRules) -> Any:
    """Tree of :class:`Sharding` for a decode cache: ``pos`` (a host int)
    and ``ring`` replicated."""
    replicated_ = Sharding(rules.mesh, ())

    def spec(path, leaf):
        name = _leaf_name(path)
        shape = _shape(leaf)
        if name in ("pos", "ring") or len(shape) == 0:
            return replicated_
        logical = CACHE_LOGICAL.get(name)
        if logical is None:
            return replicated_
        if name == "h" and len(shape) == 2:       # rec state (B, Dr)
            logical = ("batch", "tp")
        if len(shape) != len(logical):
            return replicated_
        return rules.sharding_for(shape, logical)

    return _map_with_path(spec, cache_tree)


def batch_specs(batch_tree: Any, rules: AxisRules) -> Any:
    def spec(path, leaf):
        shape = _shape(leaf)
        return rules.sharding_for(shape, ("batch",) + (None,) * (len(shape) - 1))

    return _map_with_path(spec, batch_tree)


def replicated(tree: Any, rules: AxisRules) -> Any:
    return _map_with_path(lambda _p, _l: Sharding(rules.mesh, ()), tree)


def constrain_params(tree: Any) -> Any:
    """The train step's output pin to :func:`param_specs`: ``tree``
    itself, with rules or without (see the module docstring)."""
    return tree


# ---------------------------------------------------------------------------
# Replica-plane device placement (see repro_torch/serving/replica.py)
# ---------------------------------------------------------------------------


def _cards(device) -> int:
    device = torch.device(device)
    return torch.cuda.device_count() if device.type == "cuda" else 0


def replica_devices(replicas: int, device="cuda") -> list:
    """Device assignment for an R-replica serving plane.

    With more than one CUDA device and a CUDA ``device``, replicas
    round-robin over the cards: under ``ReplicaSet(placement="overlapped")``
    each :class:`~repro_torch.serving.replica.ReplicaWorker`'s router runs
    its wave programs on its assigned card, so R wave programs from one
    drive cycle run concurrently. On one card, or on the CPU, the
    assignment is ``None`` everywhere: the workers keep the router's device
    (on one card each overlapped worker gets a CUDA stream of its own, and
    the default placement fuses same-budget replica waves along the batch
    axis instead).
    """
    n = _cards(device)
    if n <= 1:
        return [None] * int(replicas)
    return [torch.device("cuda", i % n) for i in range(int(replicas))]


def replica_mesh(replicas: int, device="cuda") -> Optional[Mesh]:
    """1-axis ``("replica",)`` mesh over the first ``min(replicas, cards)``
    cards — the binding a sharded lowering of the fused wave dispatch
    would split the batch axis over. None on the CPU or on one card
    (nothing to shard; the fused batch-axis dispatch covers it)."""
    n = min(int(replicas), _cards(device))
    if n <= 1:
        return None
    return Mesh(("replica",), (n,), tuple(torch.device("cuda", i) for i in range(n)))
