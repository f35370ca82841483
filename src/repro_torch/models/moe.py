"""Top-k mixture-of-experts MLP with capacity-bounded dispatch (the port of
``repro/models/moe.py``).

Dispatch is the JAX package's static-shape formulation:
  1. router logits (f32) -> top-k experts + softmax-renormalized combine
     weights per token,
  2. each (token, slot) pair is ranked within its expert in token-major
     arrival order (a running count of one-hots) and dropped at ranks
     ``>= capacity_for(T, E, k, capacity_factor)``,
  3. tokens are gathered into an (E, C, D) buffer, run through a batched
     expert product (E, C, D) x (E, D, F), and combined back weighted by
     the combine weights.

The expert FFN is plain ``torch.bmm`` (the JAX package computes it as
einsums outside any Pallas kernel); on the card the products go to cuBLAS.
The router product runs in f32 as JAX's does: with TF32 on for f32
matmuls (``torch.backends.cuda.matmul.allow_tf32``, off by default) the
logits would round differently and a near tie could pick another expert.

``_rank_within`` and ``moe_mlp_ep`` (expert parallelism by ``shard_map``
with all-to-alls over a mesh) have no counterpart on one card, as
``constrain`` has none: ``cfg.moe_ep`` is accepted and has no effect.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F


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
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (output (T, D) in x's dtype, f32 aux load-balancing loss)."""
    T, D = x.shape
    E = router_w.shape[1]
    C = capacity_for(T, E, k, capacity_factor)
    dev = x.device

    logits = x.float() @ router_w.float()                       # (T, E) f32
    expert_idx, combine_w = router_topk(logits, k)              # (T, k)

    # Rank of each (token, slot) within its expert, by arrival order: the
    # running count of one-hots, held expert-major so that the count runs
    # along the inner axis (on the card, a count along the outer axis of a
    # (T*k, E) one-hot runs as a serial scan per column and took most of
    # the layer's time, PERF.md section 6).
    flat_expert = expert_idx.reshape(-1)                        # (T*k,)
    experts = torch.arange(E, device=dev)[:, None]
    onehot = (experts == flat_expert[None, :]).to(torch.int32)  # (E, T*k)
    pos_in_expert = torch.cumsum(onehot, dim=1, dtype=torch.int32) - 1
    slot = pos_in_expert.gather(0, flat_expert[None, :])[0]
    keep = slot < C                                             # capacity drop

    # Scatter token features into the (E, C, D) dispatch buffer; dropped
    # pairs land on a scratch row past the buffer.
    buf_index = torch.where(keep, flat_expert * C + slot, E * C)
    token_of = torch.arange(T, device=dev).repeat_interleave(k)
    dispatch = x.new_zeros((E * C + 1, D)).index_put((buf_index,), x[token_of])
    dispatch = dispatch[: E * C].reshape(E, C, D)

    if wu is not None:                                          # SwiGLU experts
        hidden = F.silu(torch.bmm(dispatch, wg)) * torch.bmm(dispatch, wu)
    else:                                                       # GELU experts (tanh, as jax.nn.gelu)
        hidden = F.gelu(torch.bmm(dispatch, wg), approximate="tanh")
    expert_out = torch.bmm(hidden, wd)                          # (E, C, D)

    # Gather back and combine: the weights are cast to x's dtype before the
    # product and the sum over the k slots comes after, as in the JAX package.
    flat_out = expert_out.reshape(E * C, D)
    gathered = torch.where(keep[:, None], flat_out[torch.where(keep, buf_index, 0)], 0.0)
    w = combine_w.reshape(-1)[:, None].to(x.dtype)
    out = (gathered * w).reshape(T, k, D).sum(dim=1)

    # Switch-style load-balance auxiliary loss.
    probs = torch.softmax(logits, dim=-1)                       # (T, E)
    frac_tokens = F.one_hot(expert_idx[:, 0], E).float().mean(dim=0)
    frac_probs = probs.mean(dim=0)
    aux = E * (frac_tokens * frac_probs).sum()
    return out, aux
