"""GQA attention (the port of ``repro/models/attention.py``): direct path
(materialised scores), blocked flash-style path (online softmax over KV
blocks) and the dispatcher.

Shapes: q (B, S, H, hd); k (B, T, G, hd), v (B, T, G, dv) with H = G *
group_size and v's head dim dv at most hd (latent attention's v is
narrower than its q/k; out is (B, S, H, dv), the scores scaled by q's hd).
Masking supports causality, sliding windows, and a KV length limit.

Dispatch: on a CUDA tensor, prefill self-attention (``q_offset == 0``, no
``k_positions``, no ``kv_valid``) goes to the hand-written
``flash_attention`` kernel at every length — the port's form of the JAX
package's "the kernel substitutes per-op" on a TPU. On the CPU the
dispatch is the JAX package's: direct up to ``blocked_threshold``, blocked
(or prefix-bucketed) above. ``blocked_attention`` is a Python loop over KV
blocks where JAX has a jitted ``lax.scan``; neither ``jit`` nor the scan
has a counterpart here.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import ops

NEG_INF = -1e30


def _mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool, window: int) -> torch.Tensor:
    m = torch.ones((q_pos.shape[0], k_pos.shape[0]), dtype=torch.bool, device=q_pos.device)
    if causal:
        m &= q_pos[:, None] >= k_pos[None, :]
    if window > 0:
        m &= q_pos[:, None] - k_pos[None, :] < window
    return m


def _inv_sqrt(hd: int, device) -> torch.Tensor:
    """``1 / sqrt(f32(hd))`` computed in f32, as the JAX package does."""
    one = torch.ones((), dtype=torch.float32, device=device)
    return one / torch.sqrt(torch.full((), float(hd), dtype=torch.float32, device=device))


def direct_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int | torch.Tensor = 0,
    k_positions: Optional[torch.Tensor] = None,
    kv_valid: Optional[torch.Tensor] = None,   # (B, T) bool for ring buffers
) -> torch.Tensor:
    """Materialized-scores attention; use when S * T is small."""
    B, S, H, hd = q.shape
    T, G = k.shape[1], k.shape[2]
    gs = H // G
    dev = q.device
    qg = q.reshape(B, S, G, gs, hd)
    scores = torch.einsum("bsgrd,btgd->bgrst", qg.float(), k.float())
    scores = scores * _inv_sqrt(hd, dev)
    q_pos = q_offset + torch.arange(S, device=dev)
    k_pos = k_positions if k_positions is not None else torch.arange(T, device=dev)
    m = _mask(q_pos, k_pos, causal, window)
    if kv_valid is not None:
        m = m[None] & kv_valid[:, None, :]
        scores = torch.where(m[:, None, None], scores, NEG_INF)
    else:
        scores = torch.where(m[None, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bgrst,btgd->bsgrd", probs, v.float())
    return out.reshape(B, S, H, v.shape[-1]).to(q.dtype)


def blocked_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    block_kv: int = 512,
    q_offset_static: int = 0,
) -> torch.Tensor:
    """Flash-style attention: a loop over KV blocks with online softmax.

    All queries are processed in parallel against one KV block per step,
    carrying the running (max, normalizer, weighted-accumulator). Peak live
    score tensor is (B, S, H, block_kv) instead of (B, S, H, T). Every KV
    block is visited and masked, as in the JAX package.
    """
    B, S, H, hd = q.shape
    T, G = k.shape[1], k.shape[2]
    gs = H // G
    dev = q.device
    bk = min(block_kv, T)
    n_blocks = (T + bk - 1) // bk
    pad = n_blocks * bk - T
    if pad:
        k = torch.nn.functional.pad(k, (0, 0, 0, 0, 0, pad))
        v = torch.nn.functional.pad(v, (0, 0, 0, 0, 0, pad))

    qg = (q.float() / torch.sqrt(torch.full((), float(hd), dtype=torch.float32, device=dev)))
    qg = qg.reshape(B, S, G, gs, hd)
    q_pos = q_offset_static + torch.arange(S, device=dev)
    m_run = torch.full((B, S, G, gs), NEG_INF, dtype=torch.float32, device=dev)
    l_run = torch.zeros((B, S, G, gs), dtype=torch.float32, device=dev)
    acc = torch.zeros((B, S, G, gs, v.shape[-1]), dtype=torch.float32, device=dev)
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    for blk in range(n_blocks):
        kblk = k[:, blk * bk:(blk + 1) * bk].float()
        vblk = v[:, blk * bk:(blk + 1) * bk].float()
        k_pos = blk * bk + torch.arange(bk, device=dev)
        s = torch.einsum("bsgrd,btgd->bsgrt", qg, kblk)
        mask = torch.ones((S, bk), dtype=torch.bool, device=dev)
        if causal:
            mask &= q_pos[:, None] >= k_pos[None, :]
        if window > 0:
            mask &= q_pos[:, None] - k_pos[None, :] < window
        mask &= (k_pos < T)[None, :]
        mask5 = mask[None, :, None, None, :]
        s = torch.where(mask5, s, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(dim=-1))
        # Guard fully-masked prefixes: exp(-inf - -inf) would be NaN.
        safe = m_new > NEG_INF / 2
        m_safe = torch.where(safe, m_new, zero)
        alpha = torch.where(safe, torch.exp(m_run - m_safe), zero)
        p = torch.where(mask5, torch.exp(s - m_safe[..., None]), zero)
        l_run = l_run * alpha + p.sum(dim=-1)
        acc = acc * alpha[..., None] + torch.einsum("bsgrt,btgd->bsgrd", p, vblk)
        m_run = m_new
    out = acc / torch.clamp(l_run, min=1e-30)[..., None]
    return out.reshape(B, S, H, v.shape[-1]).to(q.dtype)


def bucketed_causal_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    window: int = 0,
    block_kv: int = 512,
    buckets: int = 8,
) -> torch.Tensor:
    """Causal self-attention with prefix-length bucketing: query bucket g
    only scans the first (g+1)/G of the keys."""
    B, S, H, hd = q.shape
    if S != k.shape[1]:
        raise ValueError("bucketing assumes self-attention (S == T)")
    G = buckets
    while S % G != 0 and G > 1:
        G //= 2
    step = S // G
    outs = []
    for g in range(G):
        kv_len = (g + 1) * step
        outs.append(blocked_attention(
            q[:, g * step:(g + 1) * step], k[:, :kv_len], v[:, :kv_len],
            causal=True, window=window, block_kv=min(block_kv, kv_len),
            q_offset_static=g * step,
        ))
    return torch.cat(outs, dim=1)


def attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int = 0,
    q_offset: int | torch.Tensor = 0,
    k_positions: Optional[torch.Tensor] = None,
    kv_valid: Optional[torch.Tensor] = None,
    blocked_threshold: int = 2048,
    block_kv: int = 512,
    causal_buckets: int = 0,
) -> torch.Tensor:
    """Dispatch: the ``flash_attention`` kernel for prefill self-attention on
    a CUDA tensor; on the CPU the blocked path for long self-attention and
    the direct path otherwise.

    ``causal_buckets > 0`` enables the prefix-bucketed causal scan (see
    :func:`bucketed_causal_attention`) on the CPU path."""
    S, T = q.shape[1], k.shape[1]
    prefill = (
        k_positions is None
        and kv_valid is None
        and isinstance(q_offset, int)
        and q_offset == 0
    )
    if prefill and q.device.type == "cuda":
        return ops.flash_attention(q, k, v, causal=causal, window=window)
    if prefill and S == T and T > blocked_threshold:
        if causal and causal_buckets > 0:
            return bucketed_causal_attention(
                q, k, v, window=window, block_kv=block_kv, buckets=causal_buckets
            )
        return blocked_attention(
            q, k, v, causal=causal, window=window, block_kv=block_kv,
            q_offset_static=q_offset,
        )
    return direct_attention(
        q, k, v, causal=causal, window=window, q_offset=q_offset,
        k_positions=k_positions, kv_valid=kv_valid,
    )
