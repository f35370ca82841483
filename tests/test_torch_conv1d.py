"""The depthwise causal conv of the SSM and recurrent blocks, on the CPU.

``ops.causal_conv1d`` (the plain version for a CPU tensor; on the card the
hand-written kernel, ``tests/test_torch_kernels_cuda.py``) against the
unrolled code the blocks ran before the kernel existed (with ``F.silu``
after it where the Mamba mixer applies one), bit for bit, and against the
JAX package's ``causal_conv1d`` (with ``jax.nn.silu``): f32 within the
model tests' 1e-4; bf16 within 1e-4 plus one rounding to nearest (at most
``2**-8 * |y|``) for each rounding either side makes beyond the shared
conv output: with the SiLU, PyTorch's one (``y / (1 + exp(-y))`` in f32)
and JAX's two (``x * sigmoid(x)`` in bf16 rounds the sigmoid and the
product), three in all.
``ssm.causal_conv1d``'s returned state is held to ``cat([state, x])[:,
S:]``, bit for bit. Every case runs with x contiguous and as the strided
x-half of a (B, S, 2D) projection, as the Mamba mixer splits it.
"""
import jax
import jax.experimental

if not hasattr(jax.experimental, "enable_x64"):      # removed in jax 0.9
    jax.experimental.enable_x64 = jax.enable_x64

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import ssm as jssm
from repro_torch.kernels import ops
from repro_torch.models import ssm

TOL = 1e-4
BF16_ROUNDING = 2.0 ** -8     # one rounding to nearest moves a value by at most 2^-8 |y|
B, D = 2, 24


def _unrolled(x, w, b, state):
    """The blocks' conv before the kernel, as it was written."""
    B, S, D = x.shape
    K = w.shape[1]
    if state is None:
        state = torch.zeros((B, K - 1, D), dtype=x.dtype, device=x.device)
    xt = torch.cat([state, x], dim=1)                       # (B, S+K-1, D)
    y = 0
    for i in range(K):
        y = y + xt[:, i:i + S, :].float() * w[:, i][None, None, :].float()
    y = y + b[None, None, :]
    new_state = xt[:, S:, :] if K > 1 else state
    return y.to(x.dtype), new_state


def _pair(a: np.ndarray, dtype):
    """The same values as a jax array and a CPU tensor, bit for bit."""
    if dtype == torch.float32:
        a = a.astype(np.float32)
        return jnp.asarray(a), torch.from_numpy(a)
    j = jnp.asarray(a, jnp.bfloat16)
    bits = np.asarray(j).view(np.uint16).copy()
    return j, torch.from_numpy(bits).view(torch.bfloat16)


@jax.jit
def _jax_conv(x, w, b, state):
    """The JAX package's conv, its SiLU and its state, in one compiled call."""
    y, new_state = jssm.causal_conv1d(x, w, b, state)
    return y, jax.nn.silu(y), new_state


@functools.lru_cache(maxsize=None)
def _case(S, K, with_state, dtype):
    """Inputs — x as the x-half of a (B, S, 2D) projection — and the JAX
    package's (y, SiLU(y), state) as f32 numpy arrays, shared by the
    layouts and both settings of ``silu``."""
    rng = np.random.default_rng(1000 * S + 10 * K + with_state)
    jx, x = _pair(rng.normal(0, 1, (B, S, 2 * D)), dtype)
    jw, w = _pair(rng.normal(0, 0.5, (D, K)), dtype)
    jb, b = _pair(rng.normal(0, 0.1, (D,)), dtype)
    js, st = _pair(rng.normal(0, 1, (B, K - 1, D)), dtype) if with_state else (None, None)
    want = [np.asarray(a.astype(jnp.float32)) for a in _jax_conv(jx[..., :D], jw, jb, js)]
    return x[..., :D], w, b, st, want


@pytest.mark.parametrize("silu", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("layout", ["contiguous", "split"])
@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
@pytest.mark.parametrize("K", [1, 2, 3, 4])
@pytest.mark.parametrize("S", [1, 2, 3, 4, 127])
def test_conv_matches_unrolled_and_jax(S, K, with_state, layout, dtype, silu):
    x, w, b, st, (jy, jsilu, jstate) = _case(S, K, with_state, dtype)
    if layout == "contiguous":
        x = x.contiguous()
    assert x.is_contiguous() == (layout == "contiguous")

    got = ops.causal_conv1d(x, w, b, st, silu=silu)
    y, want_state = _unrolled(x, w, b, st)
    want = F.silu(y) if silu else y
    assert got.dtype == dtype and got.shape == (B, S, D)
    assert torch.equal(got, want)
    y2, state = ssm.causal_conv1d(x, w, b, st)
    assert torch.equal(y2, y) and state.dtype == dtype
    assert state.shape == want_state.shape == (B, K - 1, D)
    assert torch.equal(state, want_state)

    jy = jsilu if silu else jy
    err = np.abs(got.float().numpy() - jy)
    rounding = (3 if silu else 1) * BF16_ROUNDING if dtype == torch.bfloat16 else 0.0
    assert (err <= TOL + max(TOL, rounding) * np.abs(jy)).all(), float(err.max())
    np.testing.assert_array_equal(state.float().numpy(), jstate)
