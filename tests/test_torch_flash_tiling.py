"""The tiling ``flash_attention``'s wrapper chooses, on the CPU.

:func:`repro_torch.kernels.flash_attention.tiling` is a pure function of
the shapes: the grid, the positions and packed query rows a block takes,
its K/V slots and shared memory, and the bytes one call copies into shared
memory. These tests hold it to the card's limits, to the bytes the function
must move at the serving path's shapes, and to a walk of the bf16 kernel's
loops written out here (which rows a block packs, which K/V tiles each M
tile walks, what it loads), so the numbers ``chip_smoke.py`` reports are the
kernel's own. Imports neither ``jax`` nor ``repro``.
"""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa

BF16, F32 = torch.bfloat16, torch.float32
# (B, S, T, H, G, hd, window) of the LM-arm route (64 queries of 127 tokens):
# the five families where the earlier kernel lost to SDPA, then smollm-135m
ROUTE = {
    "h2o-danube-1.8b": (64, 127, 127, 32, 8, 80, 4096),
    "starcoder2-7b": (64, 127, 127, 36, 4, 128, 0),
    "qwen1.5-110b": (64, 127, 127, 64, 8, 128, 0),
    "recurrentgemma-9b": (64, 127, 127, 16, 1, 256, 2048),
    "moonshot-v1-16b-a3b": (64, 127, 127, 16, 16, 128, 0),
    "smollm-135m": (64, 127, 127, 9, 3, 64, 0),
}
# shapes past the route: training, danube's binding window, prompts whose
# keys do not fit the slots, ragged S < T, rows that see no key, every
# template head dim and head dims between them, ratio 128, one query
OTHER = [
    (8, 512, 512, 9, 3, 64, 0), (1, 4608, 4608, 32, 8, 80, 4096), (1, 1100, 1100, 8, 2, 128, 0),
    (1, 1500, 1500, 4, 4, 64, 900), (2, 45, 70, 18, 2, 64, 0), (2, 40, 8, 4, 2, 32, 4),
    (3, 37, 37, 6, 3, 16, 5), (2, 70, 70, 6, 2, 40, 0), (2, 100, 100, 8, 2, 96, 0),
    (1, 129, 129, 4, 1, 112, 0), (2, 2056, 2056, 16, 1, 256, 2048), (1, 20, 20, 128, 1, 64, 0),
    (1, 1, 1, 4, 2, 8, 0), (2, 300, 300, 16, 1, 256, 64), (5, 77, 77, 12, 4, 24, 0),
]
ALL = [*ROUTE.values(), *OTHER]
GROUPED = [s for s in ALL if s[3] // s[4] > fa.V3_MAX_RATIO]     # the v4 shapes


def _ceil(a, b):
    return -(-a // b)


def _walk(B, S, T, H, G, hd, window, causal=True):
    """The bf16 kernel's loops over one call, written out: returns (real
    elements copied into shared memory, {(position, head): walked key
    range}) for batch 0 and every kv head."""
    tl = fa.tiling(B, S, T, H, G, hd, BF16, causal, window)
    R, keys, kd = H // G, tl.keys_per_tile, tl.kernel_hd
    rb, pb, hb = fa.packing(R)
    assert rb * pb <= fa.M_ROWS and rb * hb >= R and (tl.chunk_pos % pb == 0 or tl.chunk_pos >= S)

    def key_range(pa, pb_):
        return (max(0, pa - window + 1) if window > 0 else 0), (min(T, pb_ + 1) if causal else T)

    elements, walked = 0, {}
    for g in range(G):
        for z in range(tl.grid[2]):
            p0 = (tl.grid[2] - 1 - z) * tl.chunk_pos
            p1 = min(S, p0 + tl.chunk_pos)
            k_lo, k_hi = key_range(p0, p1 - 1)
            n_tiles = _ceil(k_hi - k_lo, keys) if k_hi > k_lo else 0
            resident = n_tiles <= tl.slots
            if resident:                                         # each tile once, up to T
                elements += 2 * max(0, min(T, k_lo + n_tiles * keys) - k_lo) * kd
            for m in range(_ceil(p1 - p0, pb) * hb):
                pos0, head0 = p0 + m // hb * pb, m % hb * rb
                lo, hi = key_range(pos0, min(pos0 + pb, p1) - 1)
                ta, tb = ((lo - k_lo) // keys, _ceil(hi - k_lo, keys)) if hi > lo else (0, 0)
                if not resident:
                    for t in range(ta, tb):
                        elements += 2 * (min(T, k_lo + (t + 1) * keys) - (k_lo + t * keys)) * kd
                for row in range(rb * pb):
                    key = (pos0 + row // rb, head0 + row % rb)
                    if key[0] >= p1 or key[1] >= R:
                        continue                                 # outside the tensor: not read
                    elements += kd                               # its Q row
                    key = (key[0], g * R + key[1])
                    assert key not in walked, f"packed row {key} twice"
                    walked[key] = (k_lo + ta * keys, min(k_hi, k_lo + tb * keys))
    return elements, walked


@pytest.mark.parametrize("name", [n for n in ROUTE if n != "smollm-135m"])
def test_route_fill_within_a_quarter_of_the_device_bytes(name):
    """At the five route shapes where the per-head design lost to SDPA, one
    call copies at most 1.25 times the bytes the function must move: each
    K/V tile serves its whole group (v4), or the group is one head (v3 at
    ratio 1); the per-head design copied up to 2.3 times at ratios 8-16."""
    tl = fa.tiling(*ROUTE[name][:6], BF16, True, ROUTE[name][6])
    B, S, T, H, G, hd, _ = ROUTE[name]
    assert tl.kernel == ("v3" if H // G <= fa.V3_MAX_RATIO else "v4") and tl.streaming_blocks == 0
    assert tl.fill_bytes <= 1.25 * tl.device_bytes
    assert tl.device_bytes == (2 * B * S * H + 2 * B * T * G) * hd * 2


@pytest.mark.parametrize("shape", ALL)
@pytest.mark.parametrize("dtype", [BF16, F32])
def test_tiling_fits_the_card(shape, dtype):
    B, S, T, H, G, hd, window = shape
    tl = fa.tiling(B, S, T, H, G, hd, dtype, True, window)
    assert tl.smem_bytes <= fa.SMEM_MAX == 227 * 1024
    assert tl.threads <= 1024 and tl.threads % 128 == 0
    assert tl.grid[0] <= 2 ** 31 - 1 and max(tl.grid[1:]) <= 65535 and min(tl.grid) >= 1
    assert tl.template_hd == fa.template_hd(tl.kernel_hd) >= hd
    if dtype == BF16 and tl.kernel == "v3":
        assert H // G <= fa.V3_MAX_RATIO and tl.grid == (_ceil(S, 64), H, B) and tl.threads == 128
        assert tl.smem_bytes == (64 + 4 * tl.keys_per_tile) * tl.template_hd * 2 + 1024
        assert fa.blocks_an_sm(tl.smem_bytes) >= 2
    elif dtype == BF16:
        assert H // G > fa.V3_MAX_RATIO
        assert tl.grid[:2] == (G, B) and tl.rows_per_block == tl.chunk_pos * (H // G)
        rb, pb, hb = fa.packing(H // G)
        assert tl.chunk_pos % pb == 0 or tl.chunk_pos == S
        assert (tl.grid[2] - 1) * tl.chunk_pos < S <= tl.grid[2] * tl.chunk_pos
        wgs = tl.warpgroups
        assert wgs in (1, 2) and tl.threads == 128 * wgs and 1 <= tl.q_bufs <= fa.MAX_Q_BUFS
        assert tl.o_bufs in (0, 1) and tl.slots <= fa.MAX_SLOTS
        assert tl.smem_bytes == (1024 + wgs * (tl.q_bufs + tl.o_bufs) * fa.M_ROWS * tl.template_hd * 2
                                 + 2 * tl.slots * tl.keys_per_tile * tl.template_hd * 2)
        assert fa.blocks_an_sm(tl.smem_bytes) >= (2 if wgs == 1 else 1)
        assert tl.streaming_blocks == 0 or tl.slots == 2 * wgs
    else:
        assert tl.grid == (_ceil(S, 8), H, B) and tl.kernel_hd == hd


@pytest.mark.parametrize("shape", [s for s in GROUPED if s[0] * s[1] * s[3] <= 40000])
def test_fill_and_tiles_follow_the_kernels_walk(shape):
    """The reported fill equals the walk's copies, every (position, head)
    is one packed row of one block, and the tiles each M tile walks hold
    every key its rows may see."""
    B, S, T, H, G, hd, window = shape
    tl = fa.tiling(B, S, T, H, G, hd, BF16, True, window)
    elements, walked = _walk(B, S, T, H, G, hd, window)
    assert tl.fill_bytes == B * elements * 2
    assert set(walked) == {(p, h) for p in range(S) for h in range(H)}
    for (p, h), (lo, hi) in walked.items():
        see_lo, see_hi = (max(0, p - window + 1) if window else 0), min(T, p + 1)
        assert see_hi <= see_lo or lo <= see_lo and see_hi <= hi, (p, h, lo, hi)


@pytest.mark.parametrize("shape", [s for s in ALL if s[3] // s[4] <= fa.V3_MAX_RATIO])
def test_per_head_fill_counts_each_blocks_keys(shape):
    """v3 (group ratios 1-3): each (batch, query head, 64 rows) block copies
    its Q rows and the keys its rows see, up to the last one seen."""
    B, S, T, H, G, hd, window = shape
    tl = fa.tiling(B, S, T, H, G, hd, BF16, True, window)
    keys = 0
    for q0 in range(0, S, 64):
        last = min(q0 + 64, S) - 1
        keys += max(0, min(T, last + 1) - (max(0, q0 - window + 1) if window else 0))
    assert tl.fill_bytes == B * H * (S + 2 * keys) * tl.kernel_hd * 2


def test_the_design_follows_the_shape_rule():
    """f32 runs v2; bf16 runs v3 at group ratios 1-3 and v4 above."""
    for R, want in ((1, "v3"), (2, "v3"), (3, "v3"), (4, "v4"), (9, "v4"), (16, "v4"), (128, "v4")):
        assert fa.tiling(2, 40, 40, 2 * R, 2, 64, BF16).kernel == want
        assert fa.tiling(2, 40, 40, 2 * R, 2, 64, F32).kernel == "v2"


def test_serving_chunks_keep_their_keys_resident():
    """At 127 tokens every chunk's keys fit its block's slots (loaded once);
    a prompt whose keys do not fit streams through two slots a warpgroup."""
    for shape in [s for s in ROUTE.values() if s[3] // s[4] > fa.V3_MAX_RATIO]:
        tl = fa.tiling(*shape[:6], BF16, True, shape[6])
        keys = min(shape[2], shape[1])
        assert tl.streaming_blocks == 0 and tl.slots == _ceil(keys, tl.keys_per_tile)
    tl = fa.tiling(1, 1100, 1100, 8, 2, 128, BF16, True, 0)
    assert tl.slots == 2 and 0 < tl.streaming_blocks < tl.grid[0] * tl.grid[1] * tl.grid[2]


def test_tiling_packs_a_groups_heads_and_fills_the_card():
    """A block takes whole M tiles of positions, each a group's heads; the
    grid holds at least two blocks an SM where the shape has that many M
    tiles."""
    for shape in [s for s in ROUTE.values() if s[3] // s[4] > fa.V3_MAX_RATIO]:
        B, S, T, H, G, hd, window = shape
        tl = fa.tiling(B, S, T, H, G, hd, BF16, True, window)
        blocks = tl.grid[0] * tl.grid[1] * tl.grid[2]
        rb, pb, hb = fa.packing(H // G)
        assert blocks >= min(2 * fa.SMS, B * G * _ceil(_ceil(S, pb) * hb, tl.warpgroups)) * 0.75
    assert fa.tiling(64, 127, 127, 64, 8, 128, BF16, True, 0).rows_per_block == 127 * 8


def test_packing_takes_whole_positions_of_a_group():
    assert [fa.packing(R) for R in (1, 3, 4, 8, 9, 16, 64, 65, 128)] == [
        (1, 64, 1), (3, 21, 1), (4, 16, 1), (8, 8, 1), (9, 7, 1), (16, 4, 1), (64, 1, 1),
        (64, 1, 2), (64, 1, 2)]


def test_only_a_bf16_head_dim_off_eight_is_padded():
    for H in (4, 8):                                   # v3 and v4
        for hd in (8, 40, 64, 80, 96, 112, 128, 256):
            assert fa.tiling(2, 10, 10, H, 2, hd, BF16).kernel_hd == hd
        assert fa.tiling(2, 10, 10, H, 2, 12, BF16).kernel_hd == 16
        assert fa.tiling(2, 10, 10, H, 2, 12, F32).kernel_hd == 12
