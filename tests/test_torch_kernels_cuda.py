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
from repro_torch.core.mc import GroupedXiEstimator
from repro_torch.kernels import ops, ref

pytestmark = pytest.mark.cuda

BELIEF = [(16, 4, 3), (37, 8, 5), (130, 12, 77), (832, 12, 4)]
GROUPED = [(1, 512, 4, 2, 3), (5, 700, 8, 5, 4), (3, 300, 12, 7, 6), (8, 16384, 12, 77, 3)]


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
    masks = torch.as_tensor((rng.random((G, C, L)) < 0.6).astype(np.float32), device=cuda)
    args = (est.responses, masks, est.log_weights, est.empty, est.valid,
            est.theta_f.to(torch.float32))
    before = ops.mc_correctness_grouped.launches
    got = ops.mc_correctness_grouped(*args, K)
    want = ref.mc_correctness_grouped_ref(*args, K)
    torch.cuda.synchronize()
    assert ops.mc_correctness_grouped.launches == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=2e-6)


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
