"""Hopper kernel: causal / sliding-window GQA attention (prefill hot path).

Replaces the Pallas TPU kernel ``flash_attention_pallas`` (its body is
``_kernel``) in ``src/repro/kernels/flash_attention.py``. Source:
``src/repro_torch/csrc/flash_attention.cu``; plain version:
:func:`repro_torch.kernels.ref.flash_attention_ref`; dispatching wrapper
and launch counter: :func:`repro_torch.kernels.ops.flash_attention`.

``out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, g] / sqrt(hd)) v[b, j, g]``
over the keys ``j`` query ``i`` may see (causal, ``i - j < window`` when
``window > 0``), with ``g = h // (H / G)``; f32 or bf16 in, f32 softmax
and accumulation, out in q's dtype.

What bounds it on an H100: bytes. One launch reads q, k, v once and writes
out once: at the serving path's shapes (B=64 queries, S=T=127 tokens, bf16)
that is about 25 MB for smollm-135m (H=9, G=3, hd=64), 7.5 us at 3.35 TB/s,
and about 142 MB for recurrentgemma-9b (H=16, G=1, hd=256), 42 us; the
causal FLOPs, 1.2 and 8.5 GFLOP, take 1.2 and 8.6 us at 989 TFLOP/s. The
TPU kernel tiled (512, 512) blocks onto the MXU; this first Hopper kernel
keeps every byte to one pass but does the products on the CUDA cores.

Design: one block per (batch, head, 8 query rows), one warp per row. The
block loads only the key tiles its rows can see (32 keys of k and v,
staged in shared memory as f32 by an unrolled loop, 74 KB at hd=256), so
tiles above the diagonal or outside the window cost nothing. Within a tile
the lanes go over the keys — lane j scores key j against the row's query —
and the warp takes one online-softmax step per tile in f32 (tile max and
sum by warp shuffle, one ``exp`` per lane); then the lanes go back over the
head dims (hd/32 accumulators each, in registers — hd=256 does not spill)
to add ``p_j v_j``. It takes any S and T (the ragged tail is masked in the
kernel, unlike the Pallas wrapper, which needs block multiples), any
``window >= 0`` and hd in {16, 32, 64, 128, 256}. A row that sees no key
writes 0, as the Pallas kernel does.
"""
from __future__ import annotations

import torch

from . import _build

HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
           window: int = 0) -> torch.Tensor:
    """Run the CUDA kernel: q (B, S, H, hd), k and v (B, T, G, hd), all
    contiguous, of one dtype (f32 or bf16), on one CUDA device. Returns
    (B, S, H, hd) in q's dtype; raises on a bad input or a failed launch."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"need q (B,S,H,hd) and k/v (B,T,G,hd), got {tuple(q.shape)}, {tuple(k.shape)}")
    B, S, H, hd = q.shape
    T, G = k.shape[1], k.shape[2]
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash_attention takes hd in {HEAD_DIMS}, got {hd}")
    if G < 1 or H % G:
        raise ValueError(f"query heads {H} must be a multiple of kv heads {G}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention takes {DTYPES}, got {q.dtype}")
    if max(B, H) > 65535:
        raise ValueError(f"B={B} and H={H} must each be at most 65535 (grid limit)")
    dev = q.device
    for name, t, shape in (("q", q, (B, S, H, hd)), ("k", k, (B, T, G, hd)),
                           ("v", v, (B, T, G, hd))):
        if t.device != dev or t.dtype != q.dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: need contiguous {q.dtype} {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
    out = torch.empty_like(q)
    fn = _build.entry("flash_attention")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, H, T, G, hd, int(bool(causal)), int(window),
                 int(q.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    return out
