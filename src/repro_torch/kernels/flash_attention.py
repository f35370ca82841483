"""Hopper kernels: causal / sliding-window GQA attention (prefill hot path).

Replaces the Pallas TPU kernel ``flash_attention_pallas`` (its body is
``_kernel``) in ``src/repro/kernels/flash_attention.py``. Source:
``src/repro_torch/csrc/flash_attention.cu``; plain version:
:func:`repro_torch.kernels.ref.flash_attention_ref`; dispatching wrapper
and launch counter: :func:`repro_torch.kernels.ops.flash_attention`.

``out[b, i, h] = softmax_j(q[b, i, h] . k[b, j, g] / sqrt(hd)) v[b, j, g]``
over the keys ``j`` query ``i`` may see (causal, ``i - j < window`` when
``window > 0``), with ``g = h // (H / G)``; f32 or bf16 in, f32 softmax
and accumulation, out in q's dtype.

What bounds it on an H100: bytes. One launch must read q, k, v once and
write out once: at the serving path's shapes (B=64 queries, S=T=127
tokens, bf16) 25 MB for smollm-135m (H=9, G=3, hd=64), 7.5 us at 3.35 TB/s,
up to 300 MB for qwen1.5-110b (H=64, G=8, hd=128), 89 us; the causal FLOPs
take a tenth of that or less at 989 TFLOP/s. A kernel that runs one block
per (batch, query head, 64 rows) brings each K/V tile into shared memory
once per query head of its group: up to 2.3 times the device bytes at GQA
ratios 8-16, and before this design also a pad and a slice copy at hd 80.
The TPU kernel tiled (512, 512) blocks onto the MXU with bf16 operands and
f32 accumulation, rounding p to v's dtype before the PV product.

Three designs, chosen by :func:`tiling`'s explicit shape rule (never a
fallback: a failed build or launch raises):

- **bf16, group ratio R = H / G >= 4 (v4; danube, starcoder2, qwen,
  recurrentgemma, the other GQA families):** a block takes one (batch, kv
  head) and a chunk of positions; its 64-row M tiles pack the group's R
  heads of 64 // R positions, so each K/V tile in shared memory serves the
  whole group, loaded once per block when the chunk's keys fit (every
  chunk at 127 tokens) and streamed through two slots a warpgroup
  otherwise. Both products run on the tensor cores (``wgmma``), the online
  softmax in the score registers, P rounded to bf16 as the TPU kernel
  rounds it. Every copy is a TMA box of the caller's tensors (zeros
  outside; stores clipped), issued by one thread and reported to an
  mbarrier: Q double-buffered, O staged by ``stmatrix`` and stored by TMA,
  with evict-first L2 policies for the Q/O stream and evict-last for K/V.
  One warpgroup a block and two blocks an SM, or two warpgroups sharing
  the keys where they fill the shared memory (hd 256; hd 64 at 512
  tokens); twice the chunks where keys stream.
- **bf16, R <= 3 (v3; smollm-135m, moonshot-v1-16b-a3b, training):** one
  block, one warpgroup, per (batch, query head, 64 rows), Q and two stages
  of K/V tiles by ``cp.async``, O staged for 16-byte stores. At these ratios
  a group shares little, and v3's many short blocks beat v4's long ones
  (moonshot: 0.052 against 0.054 ms; NVIDIA H100 80GB HBM3, 700 W,
  ``flash_study``).
- **f32 (v2):** the products on the CUDA cores, one warp per query row
  over 32-key f32 tiles. f32 is not on the serving path; it serves the f32
  checks and the f32 one-unit models.

What the design left on the table (``python -m
repro_torch.kernels.flash_study --timeline``): at the GQA route shapes v4
copies 0.56-0.68 of the device bytes into shared memory, yet runs at about
2.3 TB/s of device bytes, paced by memory: each M tile's Q still waits
about 1,100 cycles though it was requested an M tile ahead, and a copy of
q and out alone (no products) takes 0.86 of the kernel's time. Deeper Q
buffers, L2 prefetch, more blocks or warpgroups an SM did not move it.

Shape rules. All three take any S and T (the ragged tail is masked in the
kernel, unlike the Pallas wrapper, which needs block multiples), any
``window >= 0``, H a multiple of G, and the caller's hd as the row stride:
they are built at the template head dims ``HEAD_DIMS`` and fill the
columns past hd with zeros, storing only the real ones, so no pad or slice
runs around them. The one exception: the bf16 copies move 16-byte pieces,
which cannot start inside a row whose hd is not a multiple of 8, so for
such an hd (none of the published configs: they use 64, 80, 128, 256)
:func:`launch` zero-pads q, k and v to the next multiple of 8 and slices
the output back. A row that sees no key writes 0, as the Pallas kernel
does.
"""
from __future__ import annotations

from dataclasses import dataclass
from functools import lru_cache

import numpy as np
import torch
import torch.nn.functional as F

from . import _build

HEAD_DIMS = (16, 32, 64, 128, 256)     # the kernels' template head dims
DTYPES = (torch.float32, torch.bfloat16)

SMS = 132                  # streaming multiprocessors of an H100 SXM
SMEM_MAX = 232_448         # shared memory one block can use, bytes
M_ROWS = 64                # v4's query rows an M tile (one wgmma M)
V2_ROWS, V2_KEYS, V2_THREADS = 8, 32, 256
V3_MAX_RATIO = 3           # bf16 group ratios the per-head design (v3) takes
DESIGNS = {"v2": 2, "v3": 3, "v4": 4}   # the CUDA entry's design argument


def template_hd(hd: int) -> int:
    """The smallest template head dim that holds ``hd`` (1 <= hd <= 256)."""
    if not 1 <= hd <= HEAD_DIMS[-1]:
        raise ValueError(f"flash_attention takes 1 <= hd <= {HEAD_DIMS[-1]}, got {hd}")
    return next(t for t in HEAD_DIMS if t >= hd)


def kernel_hd(hd: int, dtype: torch.dtype) -> int:
    """The head dim the kernel is called with: ``hd`` itself, but for bf16
    the next multiple of 8 (the wrapper's one padding rule)."""
    template_hd(hd)
    return -(-hd // 8) * 8 if dtype == torch.bfloat16 else hd


@dataclass(frozen=True)
class Tiling:
    """How one call is cut: the grid (x, y, z) and threads of a block, the
    positions (v4) or query rows (v2) a block takes, the packed query rows a
    block takes at most, its K/V slots, Q buffers a warpgroup and dynamic
    shared memory; and the
    bytes the call copies from device memory into shared memory
    (``fill_bytes``: each element read once per copy, zero fills not
    counted) beside the bytes the function must move (``device_bytes``: q,
    k, v read and out written once, at the caller's hd)."""

    kernel: str
    kernel_hd: int
    template_hd: int
    keys_per_tile: int
    grid: tuple
    threads: int
    chunk_pos: int
    rows_per_block: int
    slots: int
    q_bufs: int
    o_bufs: int
    warpgroups: int
    smem_bytes: int
    streaming_blocks: int
    fill_bytes: int
    device_bytes: int


def packing(R: int):
    """(rb, pb, hb): an M tile packs ``rb`` heads of ``pb`` consecutive
    positions, and a position's heads take ``hb`` M tiles (the CUDA entry's
    ``Packing``): R heads of 64 // R positions when R <= 64, else 64 heads
    of one position."""
    rb = min(R, M_ROWS)
    return rb, (M_ROWS // R if R <= M_ROWS else 1), -(-R // rb)


MAX_Q_BUFS = 2             # v4's Q buffers a warpgroup, at most


SM_SMEM = 233_472          # shared memory of one SM, bytes; each block takes 1 KB more
MAX_SLOTS = 48             # K/V slots a block, at most (their mbarriers fit the alignment room)


def smem_bytes(tpl: int, keys: int, slots: int, q_bufs: int, wgs: int, o_bufs: int = 0) -> int:
    """v4's dynamic shared memory: ``q_bufs`` Q tiles and ``o_bufs`` O tiles
    for each of ``wgs`` warpgroups, ``slots`` K and V tiles, and 1024 bytes
    to align the start, which also hold the mbarriers (the CUDA entry
    checks the same layout)."""
    return 1024 + wgs * (q_bufs + o_bufs) * M_ROWS * tpl * 2 + 2 * slots * keys * tpl * 2


def blocks_an_sm(smem: int) -> int:
    """How many blocks of ``smem`` dynamic shared memory fit one SM."""
    return SM_SMEM // (smem + 1024)


def _key_range(pa, pb, T: int, causal: bool, window: int):
    """Keys [lo, hi) that rows at positions pa..pb see (numpy or int)."""
    hi = np.minimum(T, pb + 1) if causal else np.full_like(np.asarray(pb), T)
    lo = np.maximum(0, pa - window + 1) if window > 0 else np.zeros_like(np.asarray(pa))
    return lo, hi


@lru_cache(maxsize=4096)
def tiling(B: int, S: int, T: int, H: int, G: int, hd: int, dtype: torch.dtype,
           causal: bool = True, window: int = 0) -> Tiling:
    """The tiling :func:`launch` uses for q (B, S, H, hd), k/v (B, T, G, hd)
    of ``dtype``; a pure function of the shapes (the CUDA entry checks the
    shared memory against its own layout). f32 runs v2; bf16 runs v3 at
    group ratios up to ``V3_MAX_RATIO`` and v4 (:func:`grouped`) above."""
    if dtype == torch.bfloat16 and H // G <= V3_MAX_RATIO:
        return _per_head(B, S, T, H, G, hd, causal, window)
    return grouped(B, S, T, H, G, hd, dtype, causal, window)


def grouped(B: int, S: int, T: int, H: int, G: int, hd: int, dtype: torch.dtype,
            causal: bool = True, window: int = 0) -> Tiling:
    """v4's tiling, by these rules: one warpgroup a block, unless a block's
    resident keys leave room for only one block an SM (template hd 256 at
    127 tokens, hd 64 at 512): then two warpgroups share them; each
    warpgroup two Q buffers and an O buffer, fewer where they do not fit
    two blocks an SM (one with two warpgroups); twice the chunks where keys
    stream (long prompts)."""
    one = cut(B, S, T, H, G, hd, dtype, causal, window, wgs=1)
    if one.kernel == "v2" or not one.streaming_blocks:
        return one
    two = cut(B, S, T, H, G, hd, dtype, causal, window, wgs=2)
    if not two.streaming_blocks:
        return two
    return cut(B, S, T, H, G, hd, dtype, causal, window, wgs=1, chunk_scale=2)


def _per_head(B: int, S: int, T: int, H: int, G: int, hd: int, causal: bool,
              window: int) -> Tiling:
    """v3's tiling: a block per (batch, query head, 64 rows), its keys in
    two stages of 64-key tiles (32 at template hd 256), each row's keys
    brought in by its own block (once per query head)."""
    kd = kernel_hd(hd, torch.bfloat16)
    tpl = template_hd(kd)
    keys = 32 if tpl == 256 else 64
    starts = np.arange(0, S, M_ROWS)
    lo, hi = _key_range(starts, np.minimum(starts + M_ROWS, S) - 1, T, causal, window)
    kv_keys = int(np.clip(hi - lo, 0, None).sum())
    return Tiling("v3", kd, tpl, keys, (len(starts), H, B), 128, M_ROWS, M_ROWS, 2, 1, 0, 1,
                  (M_ROWS + 4 * keys) * tpl * 2 + 1024, 0,
                  B * H * (S * kd + 2 * kv_keys * kd) * 2, (2 * B * S * H + 2 * B * T * G) * hd * 2)


def cut(B: int, S: int, T: int, H: int, G: int, hd: int, dtype: torch.dtype, causal: bool,
        window: int, wgs: int, q_bufs: int = 2, o_bufs: int = 1, chunk_scale: int = 1) -> Tiling:
    """The tiling at ``wgs`` warpgroups a block, at most ``q_bufs`` Q
    buffers and ``o_bufs`` O buffers a warpgroup (the most that keep two
    blocks an SM with one warpgroup, one block with two) and ``chunk_scale``
    times the chunks the rule gives (bf16; f32 has one design)."""
    kd = kernel_hd(hd, dtype)
    tpl = template_hd(kd)
    esize = 2 if dtype == torch.bfloat16 else 4
    device_bytes = (2 * B * S * H + 2 * B * T * G) * hd * esize
    if dtype != torch.bfloat16:
        keys = V2_KEYS
        starts = np.arange(0, S, V2_ROWS)
        lo, hi = _key_range(starts, np.minimum(starts + V2_ROWS, S) - 1, T, causal, window)
        kv_keys = int(np.clip(hi - lo, 0, None).sum())
        fill = B * H * (S * kd + 2 * kv_keys * kd) * esize
        smem = (keys * (tpl + 1) + keys * tpl + V2_ROWS * tpl) * esize
        return Tiling("v2", kd, tpl, keys, (len(starts), H, B), V2_THREADS, V2_ROWS, V2_ROWS,
                      0, 0, 0, 0, smem, 0, fill, device_bytes)
    keys = 32 if tpl == 256 else 64
    R = H // G
    rb, pb, hb = packing(R)
    pos_tiles = -(-S // pb)                           # M tiles of one (batch, kv head, head block)
    want = -(-2 * SMS // (B * G))                     # chunks for two blocks an SM
    chunks = max(1, min(want * chunk_scale, -(-pos_tiles * hb // wgs)))
    chunk_pos = min(S, -(-pos_tiles // chunks) * pb)  # whole M tiles of positions
    chunks = -(-S // chunk_pos)
    starts = np.arange(chunks) * chunk_pos
    ends = np.minimum(starts + chunk_pos, S)
    lo, hi = _key_range(starts, ends - 1, T, causal, window)
    n_tiles = np.where(hi > lo, -(-(hi - lo) // keys), 0)
    n_max = int(n_tiles.max())
    cap = SM_SMEM // 2 - 1024 if wgs == 1 else SMEM_MAX      # two blocks an SM, or one
    fits = lambda slots, q, o: smem_bytes(tpl, keys, slots, q, wgs, o) <= cap
    slots = max(1, n_max) if n_max <= MAX_SLOTS and fits(n_max, 1, 0) else 2 * wgs
    q_bufs, o_bufs = next((q, o) for q, o in ((q_bufs, o_bufs), (q_bufs, 0), (1, o_bufs), (1, 0))
                          if fits(slots, q, o) or q == 1 and o == 0)
    resident = n_tiles <= slots
    # a K/V tile reads its keys up to T (those past the rows' causal end are masked)
    kv_keys = int(np.where(resident & (n_tiles > 0), np.minimum(T, lo + n_tiles * keys) - lo, 0).sum())
    for c in np.flatnonzero(~resident):               # streaming: each M tile walks its tiles
        first = np.arange(starts[c], ends[c], pb)
        mlo, mhi = _key_range(first, np.minimum(first + pb, ends[c]) - 1, T, causal, window)
        ta = (mlo - lo[c]) // keys
        tb = -(-(mhi - lo[c]) // keys)
        walked = np.minimum(T, lo[c] + tb * keys) - (lo[c] + ta * keys)
        kv_keys += hb * int(np.where(mhi > mlo, walked, 0).sum())
    fill = B * G * (S * R * kd + 2 * kv_keys * kd) * esize
    return Tiling("v4", kd, tpl, keys, (G, B, chunks), 128 * wgs, chunk_pos, chunk_pos * R,
                  slots, q_bufs, o_bufs, wgs, smem_bytes(tpl, keys, slots, q_bufs, wgs, o_bufs),
                  int((~resident).sum()) * B * G, fill, device_bytes)


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
    template_hd(hd)
    if G < 1 or H % G:
        raise ValueError(f"query heads {H} must be a multiple of kv heads {G}")
    if window < 0:
        raise ValueError(f"window must be >= 0, got {window}")
    if q.dtype not in DTYPES:
        raise ValueError(f"flash_attention takes {DTYPES}, got {q.dtype}")
    dev = q.device
    for name, t, shape in (("q", q, (B, S, H, hd)), ("k", k, (B, T, G, hd)),
                           ("v", v, (B, T, G, hd))):
        if t.device != dev or t.dtype != q.dtype or tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(
                f"{name}: need contiguous {q.dtype} {shape} on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}"
            )
    tl = tiling(B, S, T, H, G, hd, q.dtype, bool(causal), int(window))
    if max(B, tl.grid[1], tl.grid[2]) > 65535:
        raise ValueError(f"B={B}, H={H} and S={S} give a grid {tl.grid} past 65535 in y or z")
    kd = tl.kernel_hd
    if kd != hd:                         # bf16 with hd not a multiple of 8: the one pad
        q, k, v = (F.pad(t, (0, kd - hd)) for t in (q, k, v))
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("bf16 q, k and v must start on 16 bytes (the kernel copies 16-byte pieces)")
    scale = float(np.float32(1.0) / np.sqrt(np.float32(hd)))
    out = torch.empty_like(q)
    # explicit branches, by the tiling's shape rule: f32 -> v2 (CUDA cores);
    # bf16 -> v3 at group ratios 1-3, v4 above (tensor cores)
    fn = _build.entry("flash_attention")
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 B, S, H, T, G, kd, int(bool(causal)), int(window), DESIGNS[tl.kernel], scale,
                 tl.chunk_pos, tl.slots, tl.q_bufs, tl.o_bufs, tl.warpgroups, tl.smem_bytes, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err}")
    return out if kd == hd else out[..., :hd].contiguous()
