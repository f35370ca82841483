"""The plain versions of the port's model kernels — ``flash_attention``,
``rglru_scan`` and ``mamba_scan``, as the port's ``kernels.ops`` computes
them for CPU tensors — against the JAX package's Pallas kernels in
interpret mode (``repro.kernels.ops``) and its pure-jnp oracles
(``repro.kernels.ref``), at ``tests/test_kernels.py``'s shapes and
tolerances: 2e-5 for f32 attention and 2e-2 for bf16 (one bf16 rounding of
the output), 1e-5 for the RG-LRU scan, 3e-4 for the Mamba scan. Ragged
sequence lengths and hd=256, which the Pallas wrapper refuses (it needs
block multiples), are held against ``repro.models.attention.direct_attention``.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):      # removed in jax 0.9
    jax.experimental.enable_x64 = jax.enable_x64

import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.attention import direct_attention as jax_direct_attention
from repro_torch.kernels import _build
from repro_torch.kernels import ops


def _pair(x: np.ndarray, dtype):
    """The same values as a jax array and a CPU tensor, bit for bit (bf16
    crosses through its 16-bit pattern)."""
    j = jnp.asarray(x, dtype)
    if dtype == jnp.bfloat16:
        bits = np.asarray(j).view(np.uint16).copy()
        return j, torch.from_numpy(bits).view(torch.bfloat16)
    return j, torch.from_numpy(np.asarray(j).copy())


def _f32(t) -> np.ndarray:
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(t, np.float32)


def _qkv(B, S, T, H, G, hd, dtype, seed):
    rng = np.random.default_rng(seed)
    return [_pair(rng.normal(0, 1, shape), dtype)
            for shape in ((B, S, H, hd), (B, T, G, hd), (B, T, G, hd))]


@pytest.mark.parametrize(
    "B,S,H,G,hd,window,dtype",
    [
        (2, 128, 4, 2, 64, 0, jnp.float32),
        (1, 256, 8, 8, 32, 0, jnp.float32),
        (2, 128, 4, 1, 64, 48, jnp.float32),   # MQA + sliding window
        (1, 128, 4, 2, 64, 0, jnp.bfloat16),
    ],
)
def test_flash_attention_plain_matches_pallas_and_ref(B, S, H, G, hd, window, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(B, S, S, H, G, hd, dtype, seed=S + H)
    got = ops.flash_attention(qt, kt, vt, causal=True, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    pallas = jops.flash_attention(qj, kj, vj, causal=True, window=window, block_q=64, block_kv=64)
    oracle = jref.flash_attention_ref(qj, kj, vj, causal=True, window=window)
    atol = 2e-2 if dtype == jnp.bfloat16 else 2e-5
    np.testing.assert_allclose(_f32(got), _f32(pallas), rtol=0, atol=atol)
    np.testing.assert_allclose(_f32(got), _f32(oracle), rtol=0, atol=atol)


@pytest.mark.parametrize(
    "B,S,T,H,G,hd,window,dtype",
    [
        (2, 37, 37, 4, 2, 64, 0, jnp.float32),      # ragged S
        (1, 127, 127, 4, 1, 256, 0, jnp.float32),   # the hybrid arm's hd, ragged S
        (1, 127, 127, 4, 1, 256, 48, jnp.float32),  # ... with its local window
        (2, 37, 37, 3, 3, 16, 8, jnp.float32),      # smallest hd, window < S
        (1, 127, 127, 9, 3, 64, 0, jnp.bfloat16),   # the dense arm's heads in bf16
        (2, 20, 37, 4, 2, 32, 0, jnp.float32),      # rectangular S < T
    ],
)
def test_flash_attention_plain_ragged_matches_direct(B, S, T, H, G, hd, window, dtype):
    (qj, qt), (kj, kt), (vj, vt) = _qkv(B, S, T, H, G, hd, dtype, seed=S + hd)
    got = ops.flash_attention(qt, kt, vt, causal=True, window=window)
    want = jax_direct_attention(qj, kj, vj, causal=True, window=window)
    atol = 2e-2 if dtype == jnp.bfloat16 else 2e-5
    np.testing.assert_allclose(_f32(got), _f32(want), rtol=0, atol=atol)


@pytest.mark.parametrize("B,S,D", [(2, 64, 128), (1, 128, 512), (3, 32, 256), (3, 37, 200)])
def test_rglru_scan_plain_matches_pallas_and_ref(B, S, D):
    rng = np.random.default_rng(B + S + D)
    la = -np.abs(rng.normal(0, 0.5, (B, S, D))).astype(np.float32)
    u = rng.normal(0, 1, (B, S, D)).astype(np.float32)
    h0 = rng.normal(0, 1, (B, D)).astype(np.float32)
    gh, gl = ops.rglru_scan(torch.from_numpy(la), torch.from_numpy(u), torch.from_numpy(h0))
    wants = [jref.rglru_scan_ref(jnp.asarray(la), jnp.asarray(u), jnp.asarray(h0))]
    if D % min(512, D) == 0 and S % min(256, S) == 0:   # the Pallas wrapper's block rule
        wants.append(jops.rglru_scan(la, u, h0))
    for wh, wl in wants:
        np.testing.assert_allclose(gh.numpy(), np.asarray(wh), rtol=0, atol=1e-5)
        np.testing.assert_allclose(gl.numpy(), np.asarray(wl), rtol=0, atol=1e-5)


@pytest.mark.parametrize("B,S,Din,N", [(1, 64, 128, 8), (2, 128, 256, 16), (2, 37, 96, 8)])
def test_mamba_scan_plain_matches_pallas_and_ref(B, S, Din, N):
    rng = np.random.default_rng(B + S + Din)
    x = rng.normal(0, 1, (B, S, Din)).astype(np.float32)
    dt = np.abs(rng.normal(0, 0.3, (B, S, Din))).astype(np.float32) + 0.01
    A = -np.abs(rng.normal(1, 0.5, (Din, N))).astype(np.float32)
    Bm = rng.normal(0, 1, (B, S, N)).astype(np.float32)
    Cm = rng.normal(0, 1, (B, S, N)).astype(np.float32)
    Dk = rng.normal(0, 1, (Din,)).astype(np.float32)
    h0 = rng.normal(0, 1, (B, Din, N)).astype(np.float32)
    args = (x, dt, A, Bm, Cm, Dk, h0)
    gy, gh = ops.mamba_scan(*[torch.from_numpy(a) for a in args])
    wants = [jref.mamba_scan_ref(*[jnp.asarray(a) for a in args])]
    if Din % min(512, Din) == 0 and S % min(128, S) == 0:   # the Pallas wrapper's block rule
        wants.append(jops.mamba_scan(*args))
    for wy, wh in wants:
        np.testing.assert_allclose(gy.numpy(), np.asarray(wy), rtol=0, atol=3e-4)
        np.testing.assert_allclose(gh.numpy(), np.asarray(wh), rtol=0, atol=3e-4)


def test_wrappers_count_no_cpu_launches():
    """The plain version runs for a CPU tensor; the launch counters count
    kernel launches only."""
    ops.reset_launch_counts()
    x = torch.zeros(1, 4, 2, 16)
    ops.flash_attention(x, x[:, :, :1], x[:, :, :1])
    ops.rglru_scan(torch.zeros(1, 4, 8), torch.zeros(1, 4, 8), torch.zeros(1, 8))
    ops.mamba_scan(torch.zeros(1, 4, 8), torch.zeros(1, 4, 8), torch.zeros(8, 2),
                   torch.zeros(1, 4, 2), torch.zeros(1, 4, 2), torch.zeros(8), torch.zeros(1, 8, 2))
    ops.causal_conv1d(torch.zeros(1, 4, 8), torch.zeros(8, 4), torch.zeros(8), silu=True)
    assert (ops.flash_attention.launches, ops.rglru_scan.launches, ops.mamba_scan.launches,
            ops.causal_conv1d.launches) == (0, 0, 0, 0)


@pytest.mark.parametrize("module", ["flash_attention", "rglru_scan", "mamba_scan", "causal_conv1d"])
def test_kernel_modules_import_without_nvcc(monkeypatch, module):
    """Importing a kernel module builds nothing and needs no CUDA compiler:
    the build happens at the first launch on a CUDA tensor."""
    monkeypatch.setenv("PATH", "")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    mod = importlib.reload(importlib.import_module(f"repro_torch.kernels.{module}"))
    assert callable(mod.launch)
    assert module in _build.KERNELS and module not in _build._LOADED
    assert (_build.CSRC / f"{module}.cu").is_file()
