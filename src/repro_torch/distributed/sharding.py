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

Sharded state (ZeRO-3 over every mesh axis). Under rules whose mesh is a
``DeviceMesh`` the parameters and the optimizer state are ``DTensor`` tensors laid
out as :func:`param_specs` says (:func:`placements`: ``Shard(d)`` on the
mesh dims a spec names on tensor dim ``d``, ``Replicate()`` on the others):
:func:`distribute` is ``jax.device_put`` with shardings,
:func:`distribute_parameters` does it to a module's own parameters in
place, :func:`constrain_params` pins a tree to that layout and
:func:`gather` is ``jax.device_get``. The model computes on whole weights:
:func:`unshard` gathers a parameter at its use and sends its gradient back
to the parameter's own placements. The batch is split over the rules'
``"batch"`` axes: under such rules every tensor handed to the model is this
rank's block of the global batch (:func:`batch_block`), and the loss and the
MoE capacity count the global batch through :func:`batch_sum` and
:func:`batch_gather`.

``constrain`` returns its argument unchanged, with rules or without:
activations are not sharded (tensor-parallel compute is not ported). Each
rank computes on its own block of the batch with whole weights, which gives
the numbers of the JAX package's global program and holds the same state per
device. Expert parallelism is explicit
(:func:`repro_torch.models.moe.moe_mlp_ep` over a ``DeviceMesh``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
import sys
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
    without. Activations stay whole on their rank's batch block (see the
    module docstring); tensor-parallel compute would split them here."""
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
    """The train step's output pin: under rules whose mesh is a
    ``DeviceMesh``, every tensor leaf of ``tree`` laid out as
    :func:`param_specs` says (:func:`distribute`); ``tree`` itself without
    rules or under a layout-only mesh."""
    r = _ACTIVE
    if r is None or not is_device_mesh(r.mesh):
        return tree
    return distribute(tree, param_specs(tree, r))


# ---------------------------------------------------------------------------
# Sharded state over a DeviceMesh
# ---------------------------------------------------------------------------


def is_device_mesh(mesh) -> bool:
    """A ``torch.distributed`` ``DeviceMesh`` (it has process groups), not a
    layout :class:`Mesh`."""
    return hasattr(mesh, "get_group")


def is_distributed(x) -> bool:
    """Whether ``x`` is a ``DTensor``. Its module is imported only once a
    ``DTensor`` can exist, so the check costs no import."""
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def _dt():
    import torch.distributed.tensor as dt

    return dt


def placements(spec: Spec, mesh) -> tuple:
    """The ``DTensor`` placements of ``spec`` on a ``DeviceMesh``: per mesh
    dim, ``Shard(d)`` where the spec names that axis on tensor dim ``d``,
    else ``Replicate()``. A tuple entry shards one tensor dim over several
    mesh dims, the first named the major one, which a ``DTensor`` can hold
    only in the mesh's own dim order."""
    dt = _dt()
    names = tuple(mesh.mesh_dim_names)
    out = [dt.Replicate()] * len(names)
    for d, entry in enumerate(spec):
        axes = () if entry is None else ((entry,) if isinstance(entry, str) else tuple(entry))
        dims = [names.index(a) for a in axes]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry} runs against the mesh's dim order {names}")
        for i in dims:
            out[i] = dt.Shard(d)
    return tuple(out)


def _put(leaf, sharding: Sharding):
    """One leaf laid out by ``sharding`` (a tensor; anything else as is)."""
    if not isinstance(leaf, torch.Tensor):
        return leaf
    mesh = sharding.mesh
    want = placements(sharding.spec, mesh)
    if is_distributed(leaf):
        if leaf.device_mesh == mesh and tuple(leaf.placements) == want:
            return leaf
        if leaf.device_mesh != mesh:
            raise ValueError("a DTensor of another mesh: gather it first")
        return leaf.redistribute(mesh, want)
    # every rank holds the same values: each keeps its own block, no message
    return _dt().distribute_tensor(leaf.detach().to(mesh.device_type), mesh, want,
                                   src_data_rank=None)


def _zip_map(fn: Callable, tree: Any, other: Any) -> Any:
    """``fn(leaf, other_leaf)`` over two trees of one structure."""
    if isinstance(tree, dict):
        return {k: _zip_map(fn, v, other[k]) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_zip_map(fn, v, o) for v, o in zip(tree, other))
    if tree is None:
        return None
    return fn(tree, other)


def distribute(tree: Any, specs: Any) -> Any:
    """``jax.device_put(tree, shardings)``: each tensor leaf of ``tree`` as a
    ``DTensor`` laid out by its :class:`Sharding` (of :func:`param_specs`,
    :func:`replicated`, ...) on the sharding's ``DeviceMesh``. Every rank
    passes the same values and keeps its own block; a ``DTensor`` leaf of
    that mesh is redistributed where its placements differ."""
    return _zip_map(_put, tree, specs)


def gather(tree: Any) -> Any:
    """``jax.device_get``: every ``DTensor`` leaf of ``tree`` as its whole
    value, a plain detached tensor on the leaf's device; other leaves as
    they are. A collective: every rank of the leaves' mesh calls it."""
    return _map_with_path(
        lambda _p, x: x.full_tensor().detach() if is_distributed(x) else x, tree)


def distribute_parameters(module: torch.nn.Module, rules: Optional[AxisRules] = None):
    """Lay out ``module``'s own parameters in place as :func:`param_specs`
    of their names says on ``rules``' ``DeviceMesh`` (the active rules by
    default): each becomes a ``DTensor`` parameter, ``requires_grad`` kept.
    Returns ``module``."""
    cfg = getattr(module, "cfg", None)
    if cfg is not None and hasattr(cfg, "refuse_mla"):
        cfg.refuse_mla("the sharded step (distribute_parameters)")
    rules = rules or _ACTIVE
    if rules is None or not is_device_mesh(rules.mesh):
        raise ValueError("distribute_parameters needs rules over a DeviceMesh")
    named = dict(module.named_parameters())
    specs = param_specs(named, rules)
    for name, p in named.items():
        if is_distributed(p) and p.device_mesh == rules.mesh and \
                tuple(p.placements) == placements(specs[name].spec, rules.mesh):
            continue
        owner, _, leaf = name.rpartition(".")
        sub = module.get_submodule(owner) if owner else module
        sub._parameters[leaf] = torch.nn.Parameter(_put(p.detach(), specs[name]),
                                                   requires_grad=p.requires_grad)
    return module


def _batch_axes(mesh=None) -> Tuple[str, ...]:
    """The mesh axes of size > 1 that split the batch under the active
    rules, major first; () without rules or under a layout-only mesh.
    ``mesh`` (a ``DTensor``'s) must be the rules' mesh."""
    r = _ACTIVE
    if r is None or not is_device_mesh(r.mesh):
        return ()
    if mesh is not None and mesh != r.mesh:
        raise ValueError("a DTensor on another mesh than the active rules': its gradient "
                         "would not be summed over the rules' batch blocks")
    return tuple(a for a in r.mesh_axes("batch") if r.sizes[a] > 1)


def batch_ranks() -> Tuple[int, int]:
    """``(n, i)``: the number of batch blocks under the active rules and
    this rank's, major first (``(1, 0)`` where the batch is not split)."""
    n, i = 1, 0
    mesh = _ACTIVE.mesh if _ACTIVE is not None else None
    for a in _batch_axes():
        n, i = n * _ACTIVE.sizes[a], i * _ACTIVE.sizes[a] + mesh.get_local_rank(a)
    return n, i


def batch_block(tree: Any, microbatches: int = 1) -> Any:
    """This rank's block of a global batch (leaves (B, ...)) as
    ``batch_specs`` lays it out: of each of the ``microbatches`` global
    microbatches (consecutive rows), the rows of this rank's batch block,
    in order. The tree itself where the batch is not split."""
    n, i = batch_ranks()
    if n == 1:
        return tree

    def block(path, x):
        b = x.shape[0]
        if b % (microbatches * n):
            raise ValueError(f"batch {b} not divisible by microbatches {microbatches} x "
                             f"{n} batch blocks")
        bl = b // (microbatches * n)
        x = x.reshape(microbatches, b // microbatches, *x.shape[1:])[:, i * bl:(i + 1) * bl]
        return x.reshape(microbatches * bl, *x.shape[2:])

    return _map_with_path(block, tree)


class _BatchSum(torch.autograd.Function):
    """All-reduce sum over the batch axes' groups; the gradient passes
    through as it is: each rank's part of the sum is its own block's."""

    @staticmethod
    def forward(ctx, x, groups):
        import torch.distributed as dist

        y = x.clone()
        for g in groups:
            dist.all_reduce(y, group=g)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def batch_sum(x: torch.Tensor) -> torch.Tensor:
    """``x`` summed over the ranks that split the batch (a sum over the
    global batch when ``x`` sums this rank's block), ``x`` itself where the
    batch is not split. Its gradient is the identity, so each rank's
    gradient is its block's part, which the parameters' ``Partial`` gradient
    placements sum."""
    axes = _batch_axes()
    if not axes:
        return x
    return _BatchSum.apply(x, [_ACTIVE.mesh.get_group(a) for a in axes])


def batch_gather(x: torch.Tensor) -> torch.Tensor:
    """``(n, *x.shape)``: every batch block's ``x`` in block order (no
    gradient); ``x[None]`` where the batch is not split."""
    import torch.distributed as dist

    x, stacked = x.detach().contiguous(), False
    for a in reversed(_batch_axes()):                 # minor axis first
        parts = [torch.empty_like(x) for _ in range(_ACTIVE.sizes[a])]
        dist.all_gather(parts, x, group=_ACTIVE.mesh.get_group(a))
        x = torch.stack(parts)
        x, stacked = (x.reshape(-1, *x.shape[2:]) if stacked else x), True
    return x if stacked else x[None]


def local_part(x):
    """This rank's block of a ``DTensor``, anything else as it is."""
    return x.to_local() if is_distributed(x) else x


def like(ref, x: torch.Tensor):
    """``x``, a local block computed for ``ref``, as a ``DTensor`` of
    ``ref``'s mesh, placements and global shape where ``ref`` is one;
    ``x`` itself otherwise."""
    if not is_distributed(ref):
        return x
    return _dt().DTensor.from_local(x, ref.device_mesh, ref.placements, run_check=False,
                                    shape=ref.shape, stride=ref.stride())


def _mesh_of(refs: Sequence) -> Any:
    return next((r.device_mesh for r in refs if is_distributed(r)), None)


def shard_sums(sums: Sequence[torch.Tensor], refs: Sequence) -> list:
    """Each tensor's whole sum from ``sums``, the 0-dim sums of the local
    parts of ``refs``: summed over the mesh dims that shard it, a
    replicated dim's copies counted once (plain tensors are replicated).
    One all-reduce per mesh dim of size > 1; ``sums`` as given without a
    ``DTensor`` among ``refs``."""
    import torch.distributed as dist

    mesh = _mesh_of(refs)
    if mesh is None:
        return list(sums)
    dt = _dt()
    v = torch.stack(list(sums))
    for dim, name in enumerate(mesh.mesh_dim_names):
        if mesh.size(dim) == 1:
            continue
        first = 1.0 if mesh.get_local_rank(name) == 0 else 0.0
        keep = [1.0 if is_distributed(r) and isinstance(r.placements[dim], dt.Shard) else first
                for r in refs]
        v = v * torch.tensor(keep, dtype=v.dtype, device=v.device)
        dist.all_reduce(v, group=mesh.get_group(name))
    return list(v.unbind())


def shard_max(x: torch.Tensor, refs: Sequence) -> torch.Tensor:
    """``x`` (a max over local parts of ``refs``) maxed over every mesh dim,
    ``x`` itself without a ``DTensor`` among ``refs``."""
    import torch.distributed as dist

    mesh = _mesh_of(refs)
    if mesh is None:
        return x
    x = x.clone()
    for dim, name in enumerate(mesh.mesh_dim_names):
        if mesh.size(dim) > 1:
            dist.all_reduce(x, op=dist.ReduceOp.MAX, group=mesh.get_group(name))
    return x


def unshard(t: torch.Tensor) -> torch.Tensor:
    """A parameter whole, for compute: ZeRO-3's gather at use. A ``DTensor``
    comes back as a plain tensor on every rank, its gradient sent back as a
    ``DTensor`` with the parameter's placements: ``Partial`` over the mesh
    dims that split the batch (each rank's gradient is its block's part),
    ``Replicate`` over the others (their ranks hold the same tokens, and a
    sum there would count them twice). Anything else comes back as it is."""
    if not is_distributed(t):
        return t
    dt = _dt()
    mesh = t.device_mesh
    split = _batch_axes(mesh)
    grads = [dt.Partial() if a in split else dt.Replicate() for a in mesh.mesh_dim_names]
    return t.redistribute(mesh, [dt.Replicate()] * mesh.ndim).to_local(grad_placements=grads)


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
