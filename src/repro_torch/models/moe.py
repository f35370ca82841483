"""Top-k mixture-of-experts MLP with capacity-bounded dispatch (the port of
``repro/models/moe.py``).

Dispatch is the JAX package's static-shape formulation:
  1. router logits (f32) -> top-k experts + softmax-renormalized combine
     weights per token (or, under sigmoid scoring, the port's own: DeepSeek-V3's
     ``noaux_tc`` router with one group, :func:`router_sigmoid_topk`),
  2. each (token, slot) pair is ranked within its expert in token-major
     arrival order (a running count of one-hots) and dropped at ranks
     ``>= capacity_for(T, E, k, capacity_factor)``,
  3. tokens are gathered into an (E, C, D) buffer, run through a batched
     expert product (E, C, D) x (E, D, F), and combined back weighted by
     the combine weights.

Under sharding rules over a ``DeviceMesh`` the tokens are this rank's
block of a batch split over the rules' batch axes, and the dense path
computes what the JAX package's global program does: the capacity is that
of the global batch's tokens, a (token, slot)'s rank within its expert
counts the pairs of the lower batch blocks first (an all-gather of E
counts), and the aux loss takes the global token and probability
fractions (all-reduced sums).

The expert FFN is plain ``torch.bmm`` (the JAX package computes it as
einsums outside any Pallas kernel); on the card the products go to cuBLAS.
The router product runs in f32 as JAX's does: with TF32 on for f32
matmuls (``torch.backends.cuda.matmul.allow_tf32``, off by default) the
logits would round differently and a near tie could pick another expert.

While the profiler records (:func:`repro_torch.trace.recording`), every
call adds its routed (token, slot) pairs and those dropped past capacity to
:data:`PAIRS` by MoE shape, the dropped count kept on the device, from
zero at the recording's start: outside a recording nothing is counted and
nothing syncs.

Expert parallelism (``cfg.moe_ep``): :func:`moe_mlp_ep` is the JAX
package's ``shard_map`` body run by every process of a
``torch.distributed`` ``DeviceMesh`` (NCCL on the card, gloo on the
CPU): each rank routes its batch shard, sends each (token, slot) to the
rank that holds its expert by an all-to-all over the expert axis, runs
its local experts and sends the rows back. ``models/blocks.py`` takes
this branch under the JAX package's condition (``cfg.moe_ep``, active
sharding rules, a ``"model"`` axis); a layout-only mesh has no processes
to exchange with, and there ``cfg.moe_ep`` raises.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch import trace
from repro_torch.distributed.sharding import batch_gather, batch_ranks, batch_sum


def _total_order_key(x: torch.Tensor) -> torch.Tensor:
    """int32 keys ordered as IEEE's total order of the f32 values ``x``:
    -0.0 below +0.0, as XLA's ``top_k`` compares (``torch.sort`` ties
    them). A negative float's magnitude bits are flipped."""
    bits = x.float().contiguous().view(torch.int32)
    return bits ^ ((bits >> 31) & 0x7FFFFFFF)


def router_topk(logits: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, E) -> ((T, k) expert ids, (T, k) f32 softmax-renormalized weights).

    ``jax.lax.top_k``'s order: the k largest values in descending total
    order, the lower index first on a tie (a stable descending sort)."""
    _, idx = torch.sort(_total_order_key(logits), dim=-1, descending=True, stable=True)
    idx = idx[:, :k]
    return idx, torch.softmax(logits.gather(-1, idx).float(), dim=-1)


def router_sigmoid_topk(logits: torch.Tensor, k: int, bias: torch.Tensor,
                        scaling: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, E) f32 logits -> ((T, k) expert ids, (T, k) f32 weights) as
    DeepSeek-V3's ``noaux_tc`` router with one expert group: the k experts
    of the largest ``sigmoid(logits) + bias`` (the order of
    :func:`router_topk`), weighed by their unbiased sigmoid scores,
    normalised to sum 1 (over the sum + 1e-20, as published), then times
    ``scaling``."""
    scores = torch.sigmoid(logits.float())
    _, idx = torch.sort(_total_order_key(scores + bias.float()), dim=-1, descending=True,
                        stable=True)
    idx = idx[:, :k]
    w = scores.gather(-1, idx)
    return idx, w / (w.sum(dim=-1, keepdim=True) + 1e-20) * scaling


class PairCount:
    """Routed (token, slot) pairs and those dropped past capacity, by MoE
    shape ``(experts, k)``, over the :func:`moe_mlp` calls made since the
    profiler last started recording (:meth:`reset` is called then). The
    routed pairs are host counts (the shapes give them); the dropped pairs
    are summed on each device and read, with a sync, by :meth:`dropped`.
    ``key=None`` reads every shape's sum."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._routed: dict = {}
        self._dropped: dict = {}

    def add(self, keep: torch.Tensor, key: Tuple[int, int]) -> None:
        self._routed[key] = self._routed.get(key, 0) + keep.numel()
        with torch.inference_mode():                # an update the same in any grad mode
            acc = self._dropped.get((key, keep.device))
            if acc is None:
                acc = self._dropped[(key, keep.device)] = torch.zeros(
                    (), dtype=torch.int64, device=keep.device)
            acc.add_(keep.numel() - keep.sum())

    def keys(self) -> list:
        return sorted(self._routed)

    def routed(self, key: Optional[Tuple[int, int]] = None) -> int:
        return sum(n for k, n in self._routed.items() if key in (None, k))

    def dropped(self, key: Optional[Tuple[int, int]] = None) -> int:
        return sum(int(t) for (k, _), t in self._dropped.items() if key in (None, k))


PAIRS = PairCount()
trace.on_recording_start(PAIRS.reset)


def capacity_for(tokens: int, num_experts: int, k: int, factor: float) -> int:
    cap = int(math.ceil(tokens * k / num_experts * factor))
    return max(8, -(-cap // 8) * 8)  # round up to a multiple of 8, as the JAX package does


def moe_mlp(
    x: torch.Tensor,                 # (T, D) flattened tokens
    router_w: torch.Tensor,          # (D, E)
    wg: torch.Tensor,                # (E, D, F)
    wu: Optional[torch.Tensor],      # (E, D, F), None for the GELU variant
    wd: torch.Tensor,                # (E, F, D)
    k: int,
    capacity_factor: float = 1.25,
    *,
    scoring: str = "softmax",
    bias: Optional[torch.Tensor] = None,
    scaling: float = 1.0,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Returns (output (T, D) in x's dtype, f32 aux load-balancing loss).
    Where the batch is split over ranks, ``x`` is this rank's block and the
    capacity, the ranks within each expert and the aux are the global
    batch's (see the module docstring). Under the profiler its four parts
    are the marks ``arm.moe.route``, ``.dispatch``, ``.experts`` and
    ``.combine`` (:func:`repro_torch.trace.mark`).

    ``scoring="sigmoid"`` routes by :func:`router_sigmoid_topk` with
    ``bias`` and ``scaling``; the dispatch, experts and
    combine are the same, and no aux is computed (None): the port trains
    no sigmoid-routed model."""
    T, D = x.shape
    E = router_w.shape[1]
    blocks, block = batch_ranks()
    C = capacity_for(T * blocks, E, k, capacity_factor)
    dev = x.device

    with trace.mark("arm.moe.route"):
        logits = x.float() @ router_w.float()                   # (T, E) f32
        if scoring == "softmax":
            expert_idx, combine_w = router_topk(logits, k)      # (T, k)
        else:
            expert_idx, combine_w = router_sigmoid_topk(logits, k, bias, scaling)
    with trace.mark("arm.moe.dispatch"):
        # Rank of each (token, slot) within its expert, by arrival order: the
        # running count of one-hots, held expert-major so that the count runs
        # along the inner axis (on the card, a count along the outer axis of a
        # (T*k, E) one-hot runs as a serial scan per column and took most of
        # the layer's time, PERF.md section 6).
        flat_expert = expert_idx.reshape(-1)                    # (T*k,)
        experts = torch.arange(E, device=dev)[:, None]
        onehot = (experts == flat_expert[None, :]).to(torch.int32)  # (E, T*k)
        pos_in_expert = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
        slot = pos_in_expert.gather(0, flat_expert[None, :])[0]
        # the lower batch blocks' pairs come first in each expert (none unsplit)
        counts = batch_gather(onehot.sum(dim=1, dtype=torch.int32))       # (blocks, E)
        offset = counts[:block].sum(dim=0, dtype=torch.int32)
        keep = slot + offset[flat_expert] < C                   # capacity drop
        if trace.recording():
            PAIRS.add(keep, (E, k))

        # Scatter token features into the (E, C, D) dispatch buffer; dropped
        # pairs land on a scratch row past the buffer.
        buf_index = torch.where(keep, flat_expert * C + slot, E * C)
        token_of = torch.arange(T, device=dev).repeat_interleave(k)
        dispatch = x.new_zeros((E * C + 1, D)).index_put((buf_index,), x[token_of])
        dispatch = dispatch[: E * C].reshape(E, C, D)
    with trace.mark("arm.moe.experts"):
        if wu is not None:                                      # SwiGLU experts
            hidden = F.silu(torch.bmm(dispatch, wg)) * torch.bmm(dispatch, wu)
        else:                                                   # GELU experts (tanh, as jax.nn.gelu)
            hidden = F.gelu(torch.bmm(dispatch, wg), approximate="tanh")
        expert_out = torch.bmm(hidden, wd)                      # (E, C, D)
    with trace.mark("arm.moe.combine"):
        # Gather back and combine: the weights are cast to x's dtype before the
        # product and the sum over the k slots comes after, as in the JAX package.
        flat_out = expert_out.reshape(E * C, D)
        gathered = torch.where(keep[:, None], flat_out[torch.where(keep, buf_index, 0)], 0.0)
        w = combine_w.reshape(-1)[:, None].to(x.dtype)
        out = (gathered * w).reshape(T, k, D).sum(dim=1)
        if scoring != "softmax":
            return out, None

        # Switch-style load-balance auxiliary loss.
        probs = torch.softmax(logits, dim=-1)                   # (T, E)
        tokens = torch.full((), float(T * blocks), dtype=torch.float32, device=dev)
        first = F.one_hot(expert_idx[:, 0], E).float()          # the global batch's means
        frac_tokens = batch_sum(first.sum(dim=0)) / tokens
        frac_probs = batch_sum(probs.sum(dim=0)) / tokens
        aux = E * (frac_tokens * frac_probs).sum()
    return out, aux


# ---------------------------------------------------------------------------
# Expert-parallel MoE over a torch.distributed DeviceMesh
# ---------------------------------------------------------------------------


def _rank_within(group: torch.Tensor, n_groups: int) -> torch.Tensor:
    """Arrival-order rank of each element within its group id (a running
    count along the inner axis of a group-major one-hot)."""
    group = group.long()
    onehot = (torch.arange(n_groups, device=group.device)[:, None] == group[None, :])
    pos = torch.cumsum(onehot.to(torch.int32), dim=1, dtype=torch.int32) - 1
    return pos.gather(0, group[None, :])[0]


def _axis(mesh, name: str) -> Tuple[object, int, int]:
    """(process group, size, this rank's coordinate) of a DeviceMesh axis."""
    dim = mesh.mesh_dim_names.index(name)
    return mesh.get_group(name), mesh.size(dim), mesh.get_local_rank(name)


def local_experts(w: Optional[torch.Tensor], num_experts: int, mesh,
                  expert_axis: str = "model") -> Optional[torch.Tensor]:
    """This rank's experts of a full (E, ...) expert weight: rows ``[r *
    E_local, (r + 1) * E_local)``, ``r`` the rank's coordinate on
    ``expert_axis``."""
    if w is None:
        return None
    if w.shape[0] != num_experts:
        raise ValueError(f"an expert weight of {w.shape[0]} rows, want all {num_experts}")
    _, n_shards, r = _axis(mesh, expert_axis)
    e_local = num_experts // n_shards
    return w[r * e_local:(r + 1) * e_local]


def moe_mlp_ep(
    x_local: torch.Tensor,             # (T_l, D) this rank's batch shard of the tokens
    router_w: torch.Tensor,            # (D, E) replicated
    wg_local: torch.Tensor,            # (E_local, D, F) this rank's experts
    wu_local: Optional[torch.Tensor],  # (E_local, D, F), None for the GELU variant
    wd_local: torch.Tensor,            # (E_local, F, D)
    k: int,
    capacity_factor: float,
    mesh,
    expert_axis: str = "model",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shard-local MoE dispatch with explicit all-to-alls over the expert
    axis of ``mesh`` (a ``DeviceMesh`` with named dims; every rank calls
    it): ``(output (T_l, D) in x's dtype, f32 aux)``.

    The JAX package's ``shard_map`` body. Two-stage capacity: ``C_s``
    pairs per destination shard at dispatch, ``C_e`` per local expert after
    the exchange (the dense path's drops under balanced load). The token
    rows go out and come back by
    ``torch.distributed.nn.functional.all_to_all_single``, so gradients
    flow through both; the expert ids go out with them. ``x_local`` is
    this rank's shard of the batch over the mesh's other axes: the ranks
    along ``expert_axis`` hold the same tokens, as in the JAX package. ``aux`` is averaged over every mesh axis, as JAX's
    ``pmean`` over ``mesh.axis_names``.
    """
    import torch.distributed as dist
    import torch.distributed.nn.functional as dist_fn

    E = router_w.shape[1]
    group, n_shards, _ = _axis(mesh, expert_axis)
    if E % n_shards:
        raise ValueError(f"{E} experts do not split over {n_shards} {expert_axis!r} shards")
    E_local = E // n_shards
    for w in (wg_local, wu_local, wd_local):
        if w is not None and w.shape[0] != E_local:
            raise ValueError(f"an expert weight holds {w.shape[0]} experts, a shard {E_local}")
    T_l, D = x_local.shape
    dev = x_local.device

    logits = x_local.float() @ router_w.float()                     # (T_l, E) f32
    expert_idx, combine_w = router_topk(logits, k)                  # (T_l, k)
    flat_e = expert_idx.reshape(-1)
    token_of = torch.arange(T_l, device=dev).repeat_interleave(k)
    dest = flat_e // E_local                                         # target shard

    # stage 1: per-destination-shard send buffers (a local scatter; dropped
    # pairs land on a scratch row past the buffer)
    C_s = capacity_for(T_l, n_shards, k, capacity_factor)
    slot = _rank_within(dest, n_shards)
    keep = slot < C_s
    send_idx = torch.where(keep, dest * C_s + slot, n_shards * C_s)
    send = x_local.new_zeros((n_shards * C_s + 1, D)).index_put(
        (send_idx,), x_local[token_of])[: n_shards * C_s]
    send_e = torch.full((n_shards * C_s + 1,), -1, dtype=torch.int32, device=dev).index_put(
        (send_idx,), (flat_e % E_local).to(torch.int32))[: n_shards * C_s]

    # exchange: tokens travel to their experts' shard
    rows = dist_fn.all_to_all_single(torch.empty_like(send), send, group=group)
    re = torch.empty_like(send_e)
    dist.all_to_all_single(re, send_e, group=group)

    # stage 2: local dispatch to per-expert buffers (a local scatter)
    C_e = capacity_for(n_shards * C_s, E_local, 1, capacity_factor)
    valid = re >= 0
    slot2 = _rank_within(torch.where(valid, re, 0), E_local)
    keep2 = valid & (slot2 < C_e)
    buf_idx = torch.where(keep2, re.long() * C_e + slot2, E_local * C_e)
    buf = rows.new_zeros((E_local * C_e + 1, D)).index_put((buf_idx,), rows)
    buf = buf[: E_local * C_e].reshape(E_local, C_e, D)
    if wu_local is not None:                                        # SwiGLU experts
        hidden = F.silu(torch.bmm(buf, wg_local)) * torch.bmm(buf, wu_local)
    else:                                                           # GELU (tanh) experts
        hidden = F.gelu(torch.bmm(buf, wg_local), approximate="tanh")
    eout = torch.bmm(hidden, wd_local).reshape(E_local * C_e, D)

    # return trip: the same slots back to the source shard
    back_rows = torch.where(keep2[:, None], eout[torch.where(keep2, buf_idx, 0)], 0.0)
    back = dist_fn.all_to_all_single(torch.empty_like(back_rows), back_rows, group=group)

    gathered = torch.where(keep[:, None], back[torch.where(keep, send_idx, 0)], 0.0)
    w = combine_w.reshape(-1)[:, None].to(x_local.dtype)
    y = (gathered * w).reshape(T_l, k, D).sum(dim=1)

    # load-balance aux, averaged over every mesh axis (a replicated scalar)
    probs = torch.softmax(logits, dim=-1)
    frac_tok = F.one_hot(expert_idx[:, 0], E).float().mean(dim=0)
    aux = E * (frac_tok * probs.mean(dim=0)).sum()
    for name in mesh.mesh_dim_names:
        g, n, _ = _axis(mesh, name)
        aux = dist_fn.all_reduce(aux, group=g) / n
    return y, aux
