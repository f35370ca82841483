"""On a CUDA card only: each hand-written kernel against its plain PyTorch
version, and the port's planner on the card against the port on the CPU.

Imports neither ``jax`` nor ``repro``, so it runs on a machine with only
the port's dependencies:

    THRIFTLINT_TRACER_GUARD=0 PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

Every test carries the ``cuda`` marker and skips, with its reason, where
there is no CUDA device.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.core import selection as tsel
from repro_torch.core.mc import GroupedXiEstimator, McXiEstimator
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda

# (B, M, K): the router's shape (704 rows at M=10), K=1, K below its group
# width, K past 128 at M=40, and M past what a group holds (32 * 8 arms)
# with K past the group width
BELIEF = [(16, 4, 3), (37, 8, 5), (130, 12, 77), (832, 12, 4), (704, 10, 4), (9, 20, 1),
          (50, 40, 3), (37, 40, 129), (37, 40, 200), (37, 40, 1000), (5, 300, 33)]
# (G, theta, L, K, C), thetas ragged below theta: the CPU sweep, G=8 at
# K=77 and at K=4, K=1, K=17 and 18 (the last lcm-scaled K), K=19 (the
# first histogram-chain K), K=128, L=32 (the last register kernel), T below
# one block, T not a multiple of a cluster's span (8 or 16 blocks of 256
# draws), K=200 (folded bins) and the wide kernel at L=33, 64 and 40
GROUPED = [(1, 512, 4, 2, 3), (5, 700, 8, 5, 4), (3, 300, 12, 7, 6), (8, 16384, 12, 77, 3),
           (8, 5000, 12, 4, 5), (2, 900, 6, 1, 3), (2, 3000, 8, 17, 4), (2, 3000, 8, 18, 4),
           (2, 3000, 8, 19, 4), (1, 5000, 12, 128, 3), (2, 2000, 32, 4, 5), (1, 100, 12, 4, 3),
           (1, 6001, 12, 4, 3), (8, 5000, 12, 200, 3), (8, 16384, 33, 4, 3), (8, 16384, 64, 4, 3),
           (1, 3000, 40, 200, 3)]
# (theta, L, C, K): the Fig. 11 shape, one candidate over fewer draws than a
# block, a ragged last block at K=77, K=17 (lcm-scaled), K=1, K=19 (the
# first histogram-chain K), K=128, L=32 (the last register kernel), T not a
# multiple of a cluster's span, K=1000 on 12 arms (folded bins), the wide
# kernel at L=33, 64, 128 and 256 (class by class) and at L=40, K=1000
# (first voter by first voter), and the limit L=1024 with K past its 2050
# slots
SINGLE = [(8000, 8, 8, 4), (300, 12, 1, 4), (16843, 12, 12, 77), (1000, 8, 6, 17),
          (700, 8, 3, 1), (1000, 8, 6, 19), (3000, 12, 5, 128), (2500, 32, 7, 4),
          (4099, 12, 4, 4), (2000, 12, 5, 1000), (8471, 33, 8, 4), (8471, 64, 8, 4),
          (8471, 128, 8, 4), (3000, 256, 4, 4), (2000, 40, 5, 1000), (500, 1024, 3, 3000)]
# (G, T, L, K, C), drawn uniformly with half the arms on classes 0-2: past
# the limits of earlier versions — 1100 arms (int16 staging, one warp),
# 40000 classes on the register kernel (L=12) and the wide one (int32
# staging), and without staging: L=1100 at K=40000 and L=2100 at K=4
LIFTED = [(2, 300, 1100, 4, 3), (2, 300, 12, 40000, 3), (2, 300, 64, 40000, 3),
          (1, 300, 1100, 40000, 3), (2, 300, 2100, 4, 3), (1, 300, 2100, 40, 3)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("B,M,K", BELIEF)
def test_belief_aggregate_matches_plain(cuda, B, M, K):
    rng = np.random.default_rng(B + M)
    args = [
        torch.as_tensor(rng.integers(-1, K, (B, M)).astype(np.int32), device=cuda),
        torch.as_tensor(rng.uniform(0.3, 3.0, (B, M)).astype(np.float32), device=cuda),
        torch.as_tensor(rng.uniform(-3.0, -0.5, B).astype(np.float32), device=cuda),
    ]
    before = ops.belief_aggregate.launches
    bel, pred = ops.belief_aggregate(*args, K)
    bel_p, pred_p = ref.belief_aggregate_ref(*args, K)
    torch.cuda.synchronize()
    assert ops.belief_aggregate.launches == before + 1
    torch.testing.assert_close(bel, bel_p, rtol=0, atol=0)    # same add order
    torch.testing.assert_close(pred, pred_p, rtol=0, atol=0)


@pytest.mark.parametrize("G,theta,L,K,C", GROUPED)
def test_mc_correctness_grouped_matches_plain(cuda, G, theta, L, K, C):
    rng = np.random.default_rng(theta + G)
    est = GroupedXiEstimator(prng.key(1, cuda), rng.uniform(0.4, 0.95, (G, L)), K,
                             rng.integers(max(2, theta // 2), theta + 1, G), device=cuda)
    masks = (rng.random((G, C, L)) < 0.6).astype(np.float32)
    masks[:, -1] = 0.0                                   # the empty set too
    masks = torch.as_tensor(masks, device=cuda)
    # the draw axis cut to theta (the estimator pads it to a multiple of 256
    # draws), so T need not fill a block; thetas below it stay ragged
    resp, valid = (t[:, :theta].contiguous() for t in (est.responses, est.valid))
    args = (resp, masks, est.log_weights, est.empty, valid, est.theta_f32)
    before = ops.mc_correctness_grouped.launches
    got = ops.mc_correctness_grouped(*args, K)
    want = ref.mc_correctness_grouped_ref(*args, K)
    torch.cuda.synchronize()
    assert ops.mc_correctness_grouped.launches == before + 1
    assert got.shape == (G, C) and got.dtype == torch.float32
    # integer tie histograms and the plain version's f64 combine: bitwise
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _lifted_inputs(G, T, L, K, C, dev):
    rng = np.random.default_rng(L + K + G)
    resp = rng.integers(-1, K, (G, T, L)).astype(np.int32)
    resp[:, :, : L // 2] = rng.integers(-1, 3, (G, T, L // 2))
    masks = (rng.random((G, C, L)) < 0.6).astype(np.float32)
    masks[:, -1] = 0.0                                   # the empty set too
    valid = np.ones((G, T), np.float32)
    valid[:, T - T // 7:] = 0.0                          # a ragged theta
    arrays = (resp, masks, rng.uniform(0.3, 3.0, (G, L)).astype(np.float32),
              rng.uniform(-3.0, -0.5, G).astype(np.float32), valid,
              valid.sum(axis=1).astype(np.float32))
    return [torch.as_tensor(a, device=dev) for a in arrays]


@pytest.mark.parametrize("G,T,L,K,C", LIFTED)
def test_mc_kernels_match_plain_past_the_old_limits(cuda, G, T, L, K, C):
    resp, masks, w, empty, valid, theta = _lifted_inputs(G, T, L, K, C, cuda)
    got = ops.mc_correctness_grouped(resp, masks, w, empty, valid, theta, K)
    want = ref.mc_correctness_grouped_ref(resp, masks, w, empty, valid, theta, K)
    one = ops.mc_correctness(resp[0], masks[0], w[0], empty[:1], K)
    one_want = ref.mc_correctness_ref(resp[0], masks[0], w[0], empty[:1], K)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    torch.testing.assert_close(one, one_want, rtol=0, atol=0)


def test_mc_kernels_launch_in_chunks_past_65535(cuda):
    """G and C past the grid's 65535 launch in chunks along that axis;
    every chunk lands where it belongs, bitwise the plain version."""
    G, T, L, K, C = 65537, 8, 4, 3, 2
    resp, masks, w, empty, valid, theta = _lifted_inputs(G, T, L, K, C, cuda)
    got = ops.mc_correctness_grouped(resp, masks, w, empty, valid, theta, K)
    want = ref.mc_correctness_grouped_ref(resp, masks, w, empty, valid, theta, K)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    resp, masks, w, empty, valid, theta = _lifted_inputs(2, T, L, K, 65537, cuda)
    got = ops.mc_correctness_grouped(resp, masks, w, empty, valid, theta, K)
    want = ref.mc_correctness_grouped_ref(resp, masks, w, empty, valid, theta, K)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    one = ops.mc_correctness(resp[0].contiguous(), masks[0].contiguous(), w[0].contiguous(),
                             empty[:1], K)
    torch.testing.assert_close(one, ref.mc_correctness_ref(resp[0], masks[0], w[0], empty[:1], K),
                               rtol=0, atol=0)


@pytest.mark.parametrize("theta,L,C,K", SINGLE)
def test_mc_correctness_matches_plain(cuda, theta, L, C, K):
    rng = np.random.default_rng(theta + C)
    est = McXiEstimator(prng.key(4, cuda), rng.uniform(0.4, 0.95, L), K, theta, device=cuda)
    masks = (rng.random((C, L)) < 0.6).astype(np.float32)
    if C > 1:
        masks[-1] = 0.0                                  # the empty set too
    masks = torch.as_tensor(masks, device=cuda)
    args = (est._responses, masks, est._w, est._empty, K)
    before = ops.mc_correctness.launches
    got = ops.mc_correctness(*args)
    want = ref.mc_correctness_ref(*args)
    torch.cuda.synchronize()
    assert ops.mc_correctness.launches == before + 1
    assert got.shape == (C,) and got.dtype == torch.float32
    # integer partials and the plain version's f64 combine: bitwise
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("seed", [0, 7, 31])
def test_greedy_on_mc_xi_on_card_matches_cpu(cuda, seed):
    """GreedyLLM on the Fig. 11 pool of ``seed``: the kernel on the card
    picks what the plain version picks on the CPU, with equal values."""
    rng = np.random.default_rng(0)
    for _ in range(seed + 1):
        p, b = rng.uniform(0.4, 0.95, 8), rng.uniform(0.1, 0.6, 8)
    on_card = McXiEstimator(prng.key(seed, cuda), p, 4, 8000, use_kernel=True, device=cuda)
    on_cpu = McXiEstimator(prng.key(seed, "cpu"), p, 4, 8000, device="cpu")
    before = ops.mc_correctness.launches
    got = tsel.greedy(p, b, 1.0, on_card, empty_value=0.25)
    assert ops.mc_correctness.launches > before
    assert got == tsel.greedy(p, b, 1.0, on_cpu, empty_value=0.25)


def test_greedy_on_a_40_arm_pool_on_card_matches_cpu(cuda):
    """GreedyLLM over 40 arms, past the register kernels' 32: the wide
    kernel on the card picks what the plain version picks on the CPU."""
    rng = np.random.default_rng(40)
    p, b = rng.uniform(0.4, 0.95, 40), rng.uniform(0.05, 0.3, 40)
    on_card = McXiEstimator(prng.key(1, cuda), p, 4, 8000, use_kernel=True, device=cuda)
    on_cpu = McXiEstimator(prng.key(1, "cpu"), p, 4, 8000, device="cpu")
    before = ops.mc_correctness.launches
    got = tsel.greedy(p, b, 1.0, on_card, empty_value=0.25)
    assert ops.mc_correctness.launches > before
    assert got == tsel.greedy(p, b, 1.0, on_cpu, empty_value=0.25)


def test_planner_on_card_matches_cpu_bitwise(cuda):
    rng = np.random.default_rng(2)
    G, L, K = 8, 12, 4
    ps, b = rng.uniform(0.2, 0.98, (G, L)), rng.uniform(0.05, 1.0, L)
    budgets, thetas = rng.uniform(0.3, 2.5, G), rng.integers(120, 700, G)
    on_card = tsel.sur_greedy_many(ps, b, budgets, K, prng.key(42, cuda), thetas, device=cuda)
    on_cpu = tsel.sur_greedy_many(ps, b, budgets, K, prng.key(42, "cpu"), thetas, device="cpu")
    for s, m in zip(on_card, on_cpu):
        assert np.array_equal(s.chosen, m.chosen) and np.array_equal(s.s1, m.s1)
        assert np.array_equal(s.s2, m.s2) and s.l_star == m.l_star
        assert (s.xi_est, s.xi_s1, s.xi_s2) == (m.xi_est, m.xi_s1, m.xi_s2)


# (B, S, T, H, G, hd, window, dtype, atol): the serving path's two shapes in
# bf16 (the tensor-core kernel), bf16 at ragged lengths, a small window,
# every head dim and query/kv head ratios 1, 2, 3 and 16, then f32 cases
# (the CUDA-core kernel) with windows, ragged lengths and every head dim
FLASH = [
    (64, 127, 127, 9, 3, 64, 0, torch.bfloat16, 2e-2),
    (64, 127, 127, 16, 1, 256, 2048, torch.bfloat16, 2e-2),
    (2, 37, 45, 4, 2, 64, 0, torch.bfloat16, 2e-2),
    (3, 37, 37, 6, 3, 16, 5, torch.bfloat16, 2e-2),
    (2, 70, 70, 4, 4, 32, 0, torch.bfloat16, 2e-2),
    (1, 129, 129, 6, 2, 128, 0, torch.bfloat16, 2e-2),
    (1, 127, 127, 16, 1, 64, 0, torch.bfloat16, 2e-2),
    (1, 300, 300, 16, 1, 256, 64, torch.bfloat16, 2e-2),
    (2, 127, 127, 4, 2, 64, 0, torch.float32, 2e-5),
    (2, 127, 127, 4, 2, 64, 48, torch.float32, 2e-5),
    (1, 300, 300, 16, 1, 256, 64, torch.float32, 2e-5),
    (3, 37, 37, 6, 3, 16, 5, torch.float32, 2e-5),
    (2, 70, 70, 4, 4, 32, 0, torch.float32, 2e-5),
    (1, 129, 129, 2, 1, 128, 0, torch.float32, 2e-5),
    (2, 20, 45, 4, 2, 64, 0, torch.float32, 2e-5),
]


def _normal(shape, seed, device, dtype=torch.float32, scale=1.0):
    rng = np.random.default_rng(seed)
    return torch.as_tensor(rng.normal(0, scale, shape).astype(np.float32), device=device).to(dtype)


@pytest.mark.parametrize("B,S,T,H,G,hd,window,dtype,atol", FLASH)
def test_flash_attention_matches_plain(cuda, B, S, T, H, G, hd, window, dtype, atol):
    q = _normal((B, S, H, hd), S + hd, cuda, dtype)
    k = _normal((B, T, G, hd), T + 1, cuda, dtype)
    v = _normal((B, T, G, hd), T + 2, cuda, dtype)
    before = ops.flash_attention.launches
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    want = ref.flash_attention_ref(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert ops.flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(got.float(), want.float(), rtol=0, atol=atol)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5), (torch.bfloat16, 2e-2)])
def test_flash_attention_rows_without_keys_are_zero(cuda, dtype, atol):
    """S > T with a window leaves late rows no visible key: the kernel writes
    0 there, as the Pallas kernel and the blocked path do."""
    from repro_torch.models.attention import blocked_attention

    q, k, v = (_normal(s, i, cuda, dtype) for i, s in enumerate([(2, 40, 4, 32), (2, 8, 2, 32), (2, 8, 2, 32)]))
    got = ops.flash_attention(q, k, v, causal=True, window=4)
    want = blocked_attention(q.float(), k.float(), v.float(), causal=True, window=4, block_kv=8)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert torch.count_nonzero(got[:, 11:]) == 0
    torch.testing.assert_close(got.float(), want, rtol=0, atol=atol)


def test_flash_attention_rejects_unsupported_head_dim(cuda):
    q = torch.zeros(1, 4, 2, 48, device=cuda)
    with pytest.raises(ValueError, match="hd"):
        ops.flash_attention(q, q, q)


@pytest.mark.parametrize("B,S,D", [(64, 127, 4096), (3, 37, 200), (2, 1, 33)])
def test_rglru_scan_matches_plain(cuda, B, S, D):
    la = -_normal((B, S, D), S, cuda, scale=0.5).abs()
    u = _normal((B, S, D), S + 1, cuda)
    h0 = _normal((B, D), S + 2, cuda)
    before = ops.rglru_scan.launches
    h, h_last = ops.rglru_scan(la, u, h0)
    wh, wl = ref.rglru_scan_ref(la, u, h0)
    torch.cuda.synchronize()
    assert ops.rglru_scan.launches == before + 1
    torch.testing.assert_close(h, wh, rtol=0, atol=1e-5)
    torch.testing.assert_close(h_last, wl, rtol=0, atol=1e-5)


@pytest.mark.parametrize("B,S,Din,N", [(64, 127, 8192, 16), (2, 37, 96, 8), (1, 70, 130, 32), (2, 9, 64, 5)])
def test_mamba_scan_matches_plain(cuda, B, S, Din, N):
    x = _normal((B, S, Din), S, cuda)
    dt = _normal((B, S, Din), S + 1, cuda, scale=0.3).abs() + 0.01
    A = -_normal((Din, N), S + 2, cuda, scale=0.5).abs() - 0.5
    Bm, Cm = _normal((B, S, N), S + 3, cuda), _normal((B, S, N), S + 4, cuda)
    Dk = _normal((Din,), S + 5, cuda)
    h0 = _normal((B, Din, N), S + 6, cuda)
    before = ops.mamba_scan.launches
    y, h_last = ops.mamba_scan(x, dt, A, Bm, Cm, Dk, h0)
    wy, wh = ref.mamba_scan_ref(x, dt, A, Bm, Cm, Dk, h0)
    torch.cuda.synchronize()
    assert ops.mamba_scan.launches == before + 1
    torch.testing.assert_close(y, wy, rtol=0, atol=3e-4)
    torch.testing.assert_close(h_last, wh, rtol=0, atol=3e-4)


# (B, S, Din, N, R): the falcon-mamba path case (R + 2N = 288), a ragged
# shape, and Din whose bf16 rows do not fill 16-byte pieces (plain loads)
MAMBA_BF16 = [(64, 127, 8192, 16, 256), (2, 37, 96, 8, 6), (1, 70, 130, 5, 3)]


def _mamba_block_inputs(B, S, Din, N, R, device):
    """bf16 x, f32 dt and B, C as strided views of one bf16 (B, S, R + 2N)
    projection, as the SSM block splits it; f32 A and D."""
    x = _normal((B, S, Din), S, device, torch.bfloat16)
    dt = _normal((B, S, Din), S + 1, device, scale=0.3).abs() + 0.01
    proj = _normal((B, S, R + 2 * N), S + 3, device, torch.bfloat16)
    _, Bm, Cm = proj.split([R, N, N], dim=-1)
    A = -_normal((Din, N), S + 2, device, scale=0.5).abs() - 0.5
    return x, dt, A, Bm, Cm, _normal((Din,), S + 5, device)


@pytest.mark.parametrize("B,S,Din,N,R", MAMBA_BF16)
def test_mamba_scan_bf16_strided_no_h0_matches_plain(cuda, B, S, Din, N, R):
    args = _mamba_block_inputs(B, S, Din, N, R, cuda)
    assert not args[3].is_contiguous()
    before = ops.mamba_scan.launches
    y, h_last = ops.mamba_scan(*args, None)
    # the plain version on an f32 copy of x leaves y unrounded
    wy, wh = ref.mamba_scan_ref(args[0].float(), *args[1:], None)
    torch.cuda.synchronize()
    assert ops.mamba_scan.launches == before + 1
    assert y.dtype == torch.bfloat16 and h_last.dtype == torch.float32
    # h_last to the scan's tolerance; the bf16 y to it plus one rounding to
    # nearest of the unrounded y (at most 2^-8 |y|)
    torch.testing.assert_close(h_last, wh, rtol=0, atol=3e-4)
    err = (y.float() - wy).abs()
    assert bool((err <= 3e-4 + 2.0 ** -8 * wy.abs()).all()), float(err.max())


def test_mamba_scan_widens_a_bf16_dt(cuda):
    """The kernel takes dt in f32 only; the wrapper widens a bf16 dt, which
    is exact, so the result is bit for bit that of the f32 copy."""
    x, dt, A, Bm, Cm, D = _mamba_block_inputs(2, 37, 96, 8, 6, cuda)
    dt16 = dt.to(torch.bfloat16)
    got = ops.mamba_scan(x, dt16, A, Bm, Cm, D)
    want = ops.mamba_scan(x, dt16.float(), A, Bm, Cm, D)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_mamba_scan_bf16_makes_no_f32_copy(cuda):
    """On the bf16 path the wrapper allocates y (bf16), h_last and D in f32,
    and nothing of x's size in f32: no widened copy of x or y, and dt (f32,
    as the block gives it) goes in as it is."""
    args = _mamba_block_inputs(8, 127, 4096, 16, 256, cuda)
    ops.mamba_scan(*args)                   # builds the kernel first
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(cuda)
    base = torch.cuda.memory_allocated(cuda)
    y, h_last = ops.mamba_scan(*args)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated(cuda) - base
    assert grown < args[0].numel() * 4, (grown, args[0].numel() * 4)


@pytest.mark.parametrize("arch", ["smollm-135m", "recurrentgemma-9b", "falcon-mamba-7b"])
def test_smoke_lm_on_card_matches_cpu(cuda, arch):
    """The ``SMOKE`` models in f32, kernels on the card against the plain
    versions on the CPU, same weights (TF32 off: full f32 matmuls)."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.models import LM

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = LM(get_smoke_config(arch), device=cuda, seed=3)
    tokens = torch.as_tensor(np.random.default_rng(0).integers(0, 512, (2, 63)), device=cuda)
    ops.reset_launch_counts()
    with torch.inference_mode():
        got = model(tokens).cpu()
        launched = (ops.flash_attention.launches, ops.rglru_scan.launches, ops.mamba_scan.launches)
        want = model.to("cpu")(tokens.cpu())
    kinds = set(model.cfg.layer_types)
    assert launched == (sum(t == "attn" for t in model.cfg.layer_types),
                        sum(t == "rec" for t in model.cfg.layer_types),
                        sum(t == "ssm" for t in model.cfg.layer_types)), (kinds, launched)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
