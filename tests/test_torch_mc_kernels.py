"""The ``mc_correctness`` kernels' CPU-side contract: the identity their
shared CUDA body rests on, the wrappers' size checks (any L <= 1024 arms,
any K <= 32767 classes, refused past that before a build), the estimator's
f32 theta, and ``_build``'s library names, which hash the headers the
sources include and the compiler's version. The kernels against their
plain versions, on a card, are in ``test_torch_kernels_cuda.py``.

Imports neither ``jax`` nor ``repro``.
"""
import types

import numpy as np
import pytest
import torch

from repro_torch.core import prng
from repro_torch.core.mc import GroupedXiEstimator, sample_pool_responses
from repro_torch.kernels import _build
from repro_torch.kernels import mc_correctness as mck
from repro_torch.kernels import ops, ref


# (theta, L, C, K): K=1, K=17 and 18 (lcm(1..18) < 2^24: the last
# lcm-scaled K), K=19 (the first histogram-chain K), K=77, K=128, L=32 (the
# last register kernel) and wide pools, L=33 past 128 classes and L=40
IDENTITY = [(300, 4, 3, 1), (700, 8, 5, 17), (700, 8, 5, 18), (700, 8, 5, 19),
            (1000, 12, 6, 77), (500, 12, 4, 128), (400, 32, 5, 4), (300, 33, 4, 150),
            (400, 40, 5, 4)]


@pytest.mark.parametrize("theta,L,C,K", IDENTITY)
def test_single_pool_plain_is_the_grouped_plain_at_g1(theta, L, C, K):
    """``mc_correctness_ref`` is ``mc_correctness_grouped_ref`` at G=1 with
    every draw valid and theta = T, bit for bit: one kernel body serves
    both."""
    rng = np.random.default_rng(theta + K)
    p = rng.uniform(0.3, 0.95, L).astype(np.float32)
    resp = sample_pool_responses(prng.key(K, "cpu"), p, K, theta)
    masks = (rng.random((C, L)) < 0.6).astype(np.float32)
    masks[-1] = 0.0
    masks = torch.as_tensor(masks)
    w = torch.as_tensor(rng.uniform(-2.0, 3.0, L).astype(np.float32))
    empty = torch.tensor([-1.7], dtype=torch.float32)
    single = ref.mc_correctness_ref(resp, masks, w, empty, K)
    grouped = ref.mc_correctness_grouped_ref(
        resp[None], masks[None], w[None], empty, torch.ones((1, theta)),
        torch.tensor([float(theta)], dtype=torch.float32), K,
    )
    assert single.dtype == grouped.dtype == torch.float32
    assert torch.equal(single, grouped[0])


KERNELS = ["mc_correctness", "mc_correctness_grouped"]


def _call(kernel: str, T: int, L: int, K: int):
    resp = torch.zeros((T, L), dtype=torch.int32)
    masks, w, empty = torch.ones((2, L)), torch.zeros(L), torch.zeros(1)
    if kernel == "mc_correctness":
        return mck.launch(resp, masks, w, empty, K)
    return mck.launch_grouped(resp[None], masks[None], w[None], empty, torch.ones((1, T)),
                              torch.full((1,), float(T)), K)


# (L, K): pools past the register kernels' 32 arms, classes past the 128 the
# histograms once held, and the limits themselves
TAKEN = [(33, 4), (64, 4), (256, 4), (12, 129), (40, 1024), (mck.MAX_ARMS, mck.MAX_CLASSES)]


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("L,K", TAKEN)
def test_wrappers_take_wide_pools_and_many_classes(kernel, L, K, monkeypatch):
    """The checks pass L and K through to the entry point as they are."""
    calls = []
    monkeypatch.setattr(mck, "_run", lambda name, dev, *args: calls.append((name, args)))
    out = _call(kernel, 300, L, K)
    assert [name for name, _ in calls] == [kernel]
    assert calls[0][1][-3:-1] == (L, K)
    assert out.shape == ((2,) if kernel == "mc_correctness" else (1, 2))


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("L,K,reason", [
    (mck.MAX_ARMS + 1, 4, r"L <= 1024 arms .*shared memory"),
    (12, mck.MAX_CLASSES + 1, r"K <= 32767 classes .*int16"),
    (12, 0, r"1 <= K"),
])
def test_wrappers_refuse_past_the_limits_before_building(kernel, L, K, reason, monkeypatch):
    def no_build(*args):
        raise AssertionError("the kernel was built")

    monkeypatch.setattr(_build, "build", no_build)
    monkeypatch.setattr(_build, "entry", no_build)
    with pytest.raises(ValueError, match=reason):
        _call(kernel, 300, L, K)


def test_grouped_estimator_caches_its_f32_theta():
    """The kernel's theta is cast once, in ``__init__``; on the CPU the
    kernel route is the plain version on that theta."""
    rng = np.random.default_rng(3)
    ps, thetas = rng.uniform(0.3, 0.95, (3, 8)), np.array([300, 517, 800])
    est = GroupedXiEstimator(prng.key(5, "cpu"), ps, 4, thetas, use_kernel=True, device="cpu")
    assert est.theta_f32.dtype == torch.float32
    assert torch.equal(est.theta_f32, torch.as_tensor(thetas, dtype=torch.float32))
    masks = (rng.random((3, 4, 8)) < 0.5).astype(np.float32)
    before = ops.mc_correctness_grouped.launches
    got = est(masks)
    want = ref.mc_correctness_grouped_ref(
        est.responses, torch.as_tensor(masks), est.log_weights, est.empty, est.valid,
        est.theta_f32, 4,
    ).to(torch.float64)
    assert torch.equal(got, want)
    assert ops.mc_correctness_grouped.launches == before


def test_library_path_hashes_the_headers(tmp_path, monkeypatch):
    """An edited header rebuilds every source (a source may include any
    header); an edit elsewhere in the directory does not."""
    (tmp_path / "k.cu").write_text('#include "body.cuh"\n')
    (tmp_path / "body.cuh").write_text("// v1\n")
    (tmp_path / "notes.txt").write_text("a\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    first = _build.library_path("k")
    assert _build.library_path("k") == first
    (tmp_path / "notes.txt").write_text("b\n")
    assert _build.library_path("k") == first
    (tmp_path / "body.cuh").write_text("// v2\n")
    second = _build.library_path("k")
    assert second != first and second.parent == first.parent
    (tmp_path / "extra.cuh").write_text("// new\n")
    assert _build.library_path("k") != second
    (tmp_path / "k.cu").write_text('#include "body.cuh"\n// edited\n')
    assert _build.library_path("k") not in (first, second)


def test_the_real_sources_include_the_shared_body():
    for name in ("mc_correctness", "mc_correctness_grouped"):
        assert '#include "mc_tie_hist.cuh"' in (_build.CSRC / f"{name}.cu").read_text()
    assert (_build.CSRC / "mc_tie_hist.cuh").exists()


def test_library_path_hashes_the_compiler_version(monkeypatch):
    """Another CUDA toolkit rebuilds every library: its ``nvcc --version``
    is part of the name."""
    monkeypatch.setattr(_build, "nvcc_version", lambda: "Cuda compilation tools, release 12.4")
    first = _build.library_path("belief_aggregate")
    assert _build.library_path("belief_aggregate") == first
    monkeypatch.setattr(_build, "nvcc_version", lambda: "Cuda compilation tools, release 12.8")
    second = _build.library_path("belief_aggregate")
    assert second != first and second.parent == first.parent


def test_nvcc_version_is_read_once_per_process(monkeypatch):
    runs = []

    def run(cmd, **kwargs):
        runs.append(cmd)
        return types.SimpleNamespace(stdout="release 12.8, V12.8.93\n")

    monkeypatch.setattr(_build, "nvcc_path", lambda: "/toolkit/bin/nvcc")
    monkeypatch.setattr(_build, "subprocess", types.SimpleNamespace(run=run))
    _build.nvcc_version.cache_clear()
    try:
        assert _build.nvcc_version() == "release 12.8, V12.8.93\n"
        _build.library_path("mc_correctness")
        _build.library_path("belief_aggregate")
        assert runs == [["/toolkit/bin/nvcc", "--version"]]
    finally:
        _build.nvcc_version.cache_clear()
