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
TPU kernel tiled (512, 512) blocks onto the MXU with bf16 operands and f32
accumulation, rounding p to v's dtype before the PV product.

The launch branches on dtype, explicitly:

- **bf16 (v3, the LM arms' path):** both products on the tensor cores
  by ``wgmma.mma_async`` (bf16 in, f32 accumulate). One block, one
  warpgroup, per (batch, head, 64 query rows). Q and K/V tiles of 64 keys
  (32 at hd=256, so that two blocks fit on an SM) are staged as bf16 by
  ``cp.async`` in the swizzled layout wgmma reads (128-byte rows; 32 and
  64 bytes at hd 16 and 32), K/V double-buffered, walking only the tiles
  the rows can see. S = Q K^T reads both operands from shared memory; the
  online softmax stays in the score accumulators (row max and sum by
  shuffles among the four threads of a row, ``exp2`` on scores pre-scaled
  by ``scale * log2(e)``); P is rounded to bf16, as the TPU kernel rounds
  it, and fed from registers as the A operand of ``O += P V``. The grid
  runs all query heads of one (batch, kv head) together, so K/V come from
  L2. The block's load of Q and its store of O take as long as its tiles
  at the path shapes (the phases line up across the card and saturate
  device memory in turn): that, not the products, is what keeps it above
  its byte bound.
- **f32 (v2):** the products on the CUDA cores, one warp per query row
  over 32-key f32 tiles (lanes over keys for the scores, over head dims for
  ``p_j v_j``). f32 is not on the serving path; it serves the f32 checks
  and the f32 one-unit models.

Both take any S and T (the ragged tail is masked in the kernel, unlike the
Pallas wrapper, which needs block multiples), any ``window >= 0``, any hd
from 1 to 256 and H a multiple of G. The kernels are built at the head
dims ``HEAD_DIMS``; :func:`launch` zero-pads q, k and v to the next of
them (zero columns add nothing to a score and give zero output columns)
and slices the output back, passing the true hd's scale ``1 / sqrt(hd)``
in f32, as the JAX package's wrappers handle padding and layout. A row
that sees no key writes 0, as the Pallas kernel does. No path routes a
call to the other version or to the plain one: a failed build or launch
raises.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

HEAD_DIMS = (16, 32, 64, 128, 256)     # the kernels' template head dims
DTYPES = (torch.float32, torch.bfloat16)


def template_hd(hd: int) -> int:
    """The smallest template head dim that holds ``hd`` (1 <= hd <= 256)."""
    if not 1 <= hd <= HEAD_DIMS[-1]:
        raise ValueError(f"flash_attention takes 1 <= hd <= {HEAD_DIMS[-1]}, got {hd}")
    return next(t for t in HEAD_DIMS if t >= hd)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = True,
           window: int = 0) -> torch.Tensor:
    """Run the CUDA kernel: q (B, S, H, hd), k and v (B, T, G, hd), all
    contiguous, of one dtype (f32 or bf16), on one CUDA device, 1 <= hd <=
    256. Returns (B, S, H, hd) in q's dtype; raises on a bad input or a
    failed launch."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"need q (B,S,H,hd) and k/v (B,T,G,hd), got {tuple(q.shape)}, {tuple(k.shape)}")
    B, S, H, hd = q.shape
    T, G = k.shape[1], k.shape[2]
    tpl = template_hd(hd)
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
    if tpl != hd:                        # zero-pad the head dim to the template's
        q, k, v = (F.pad(t, (0, tpl - hd)) for t in (q, k, v))
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("bf16 q, k and v must start on 16 bytes (the kernel copies 16-byte pieces)")
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    out = torch.empty_like(q)
    # explicit dtype branch: bf16 -> v3 (tensor cores), f32 -> v2 (CUDA cores)
    fn = _build.entry("flash_attention")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, H, T, G, tpl, int(bool(causal)), int(window),
                 int(q.dtype == torch.bfloat16), scale, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    return out if tpl == hd else out[..., :hd].contiguous()
