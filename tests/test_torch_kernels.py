"""The port's kernels: plain versions against the JAX package's Pallas
kernels (interpret mode) and pure-jnp oracles, and the CPU/CUDA dispatch
rules. Each CUDA kernel against its plain version, on a card, is in
``test_torch_kernels_cuda.py``.

Tolerances are the reference's own (``tests/test_kernels.py``): beliefs to
1e-6 with equal predictions, grouped xi to 2e-6.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):      # removed in jax 0.9
    jax.experimental.enable_x64 = jax.enable_x64

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.mc import GroupedXiEstimator as JaxGroupedXiEstimator
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import belief_aggregate as tba
from repro_torch.kernels import ops as tops

ROOT = Path(__file__).resolve().parents[1]

# the tests/test_kernels.py belief sweep, plus the router's prefix layout
BELIEF = [(16, 4, 3), (37, 8, 5), (130, 12, 77)]
# the tests/test_kernels.py grouped sweep, plus K=77
GROUPED = [(1, 512, 4, 2, 3), (5, 700, 8, 5, 4), (3, 300, 12, 7, 6), (2, 300, 12, 77, 3)]


def _belief_case(B, M, K):
    rng = np.random.default_rng(B + M)
    responses = rng.integers(-1, K, (B, M)).astype(np.int32)
    w = rng.uniform(0.3, 3.0, (B, M)).astype(np.float32)
    empty = rng.uniform(-3.0, -0.5, B).astype(np.float32)
    return responses, w, empty


@pytest.mark.parametrize("B,M,K", BELIEF)
def test_belief_aggregate_plain_matches_pallas_and_oracle(B, M, K):
    responses, w, empty = _belief_case(B, M, K)
    bel, pred = tops.belief_aggregate(
        torch.as_tensor(responses), torch.as_tensor(w), torch.as_tensor(empty), K
    )
    assert bel.dtype == torch.float32 and pred.dtype == torch.int32
    for fn in (jops.belief_aggregate, jref.belief_aggregate_ref):
        wb, wp = fn(jnp.asarray(responses), jnp.asarray(w), jnp.asarray(empty), K)
        np.testing.assert_allclose(bel.numpy(), np.asarray(wb), atol=1e-6)
        np.testing.assert_array_equal(pred.numpy(), np.asarray(wp))


@pytest.mark.parametrize("K", [4, 77])
def test_belief_aggregate_router_prefix_layout(K):
    """The wave program's call: (M,)-shaped rows of every prefix of every
    query, broadcast (M,) weights and a scalar empty belief."""
    B, T = 9, 6
    rng = np.random.default_rng(K)
    resp = rng.integers(0, K, (B, T))
    hist = np.where(np.arange(T + 1)[None, :, None] > np.arange(T)[None, None, :],
                    resp[:, None, :], -1).reshape(-1, T).astype(np.int32)
    w = rng.uniform(0.3, 3.0, T).astype(np.float32)
    bel, pred = tops.belief_aggregate(torch.as_tensor(hist), torch.as_tensor(w), -1.25, K)
    wb, wp = jops.belief_aggregate(jnp.asarray(hist), jnp.asarray(w), jnp.float32(-1.25), K, tile=512)
    np.testing.assert_allclose(bel.numpy(), np.asarray(wb), atol=1e-6)
    np.testing.assert_array_equal(pred.numpy(), np.asarray(wp))
    assert (bel.numpy()[:: T + 1] == -1.25).all()    # the empty prefix


@pytest.mark.parametrize("G,theta,L,K,C", GROUPED)
def test_mc_correctness_grouped_plain_matches_pallas_and_oracle(G, theta, L, K, C):
    rng = np.random.default_rng(theta + G)
    ps = rng.uniform(0.4, 0.95, (G, L))
    thetas = rng.integers(max(2, theta // 2), theta + 1, G)
    est = JaxGroupedXiEstimator(jax.random.key(1), ps, K, thetas)
    masks = (rng.random((G, C, L)) < 0.6).astype(np.float32)
    got = tops.mc_correctness_grouped(
        torch.as_tensor(est.responses), torch.as_tensor(masks),
        torch.as_tensor(est.log_weights), torch.as_tensor(est.empty),
        torch.as_tensor(est.valid), torch.as_tensor(est.theta_f.astype(np.float32)), K,
    ).numpy()
    assert got.dtype == np.float32 and got.shape == (G, C)
    pallas = jops.mc_correctness_grouped(
        jnp.asarray(est.responses), jnp.asarray(masks), jnp.asarray(est.log_weights),
        jnp.asarray(est.empty), jnp.asarray(est.valid),
        jnp.asarray(est.theta_f, jnp.float32), K,
    )
    np.testing.assert_allclose(got, np.asarray(pallas), atol=2e-6)
    # same exact f64 core rounded to f32 on both sides: bitwise
    oracle = jref.mc_correctness_grouped_ref(
        est.responses, masks, est.log_weights, est.empty, est.valid, est.theta_f, K,
    )
    np.testing.assert_array_equal(got, np.asarray(oracle))


def test_cpu_calls_use_the_plain_version_and_count_no_launch():
    before = (tops.belief_aggregate.launches, tops.mc_correctness_grouped.launches)
    responses, w, empty = _belief_case(16, 4, 3)
    tops.belief_aggregate(torch.as_tensor(responses), torch.as_tensor(w), torch.as_tensor(empty), 3)
    assert (tops.belief_aggregate.launches, tops.mc_correctness_grouped.launches) == before


def test_other_devices_raise():
    with pytest.raises(ValueError, match="cpu .* or cuda"):
        tops.belief_aggregate(torch.zeros((2, 3), dtype=torch.int32, device="meta"),
                              torch.zeros(3), 0.0, 4)


def test_launch_validates_before_building():
    """Bad inputs are refused before the builder is consulted."""
    resp = torch.zeros((4, 3), dtype=torch.int64)
    with pytest.raises(ValueError, match="responses"):
        tba.launch(resp, torch.zeros((4, 3)), torch.zeros(4), 5)
    with pytest.raises(ValueError, match="K >= 1"):       # any K >= 1 is taken
        tba.launch(resp.to(torch.int32), torch.zeros((4, 3)), torch.zeros(4), 0)


def test_kernel_modules_import_without_nvcc():
    """Importing the kernels (and using them on the CPU) needs no CUDA
    compiler: the build is deferred to the first CUDA launch."""
    env = dict(os.environ, PATH="/usr/bin:/bin", PYTHONPATH=str(ROOT / "src"))
    env.pop("CUDA_HOME", None)
    code = (
        "import torch\n"
        "from repro_torch.kernels import _build, ops, belief_aggregate, mc_correctness\n"
        "bel, pred = ops.belief_aggregate(torch.zeros((2, 3), dtype=torch.int32), torch.ones(3), -1.0, 4)\n"
        "assert _build._LOADED == {} and ops.belief_aggregate.launches == 0\n"
        "try:\n"
        "    _build.nvcc_path()\n"
        "except RuntimeError:\n"
        "    print('no-nvcc')\n"
        "else:\n"
        "    print('nvcc-present')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() in ("no-nvcc", "nvcc-present")
