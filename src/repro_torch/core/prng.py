"""Torch emulation of jax's ``threefry2x32`` PRNG (partitionable mode).

The planner's common-random-number draws must be the reference's bit for
bit: plans are discrete, so without identical draws neither the planner
nor the router could be compared with the JAX package beyond statistics.
This module reproduces exactly the pieces of ``jax.random`` that
``core/mc.py`` uses, with ``jax_threefry_partitionable=True``:

* :func:`key` — ``jax.random.key(seed)`` (a 64-bit seed split into two
  32-bit words, high word first);
* :func:`split` — ``jax.random.split(key)``: the hash of the 64-bit
  counters 0 and 1;
* :func:`fold_in` — ``jax.random.fold_in(key, data)``: the hash of the
  counter ``(0, data)``;
* :func:`uniform` — the f32 mantissa construction of ``jax.random.uniform``
  over ``[0, 1)``;
* :func:`randint` — ``jax.random.randint`` for int32 outputs: two 32-bit
  draws combined modulo the span, with ``span`` clamped to 1 when
  ``maxval <= minval``.

A key is a pair ``(k0, k1)`` of int64 tensors holding 32-bit words, of any
(broadcastable) shape, so a whole batch of folded keys is one tensor pair.
All arithmetic is int64 masked to 32 bits — no ``torch.uint32`` arithmetic
— so the same code runs on the CPU and on CUDA.
"""
from __future__ import annotations

from typing import Tuple

import torch

Key = Tuple[torch.Tensor, torch.Tensor]

_M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = 0x1BD11BDA


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & _M32


def threefry2x32(k0, k1, x0, x1) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block cipher (20 rounds) on 32-bit words.

    ``k0, k1`` are the key words, ``x0, x1`` the counter words; all four
    broadcast together. Returns the two output words.
    """
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _M32
    x1 = (x1 + ks[1]) & _M32
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _M32
            x1 = _rotl(x1, r)
            x1 = x0 ^ x1
        x0 = (x0 + ks[(i + 1) % 3]) & _M32
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x0, x1


def key(seed: int, device="cuda") -> Key:
    """``jax.random.key(seed)`` for a non-negative integer seed."""
    seed = int(seed)
    if seed < 0:
        raise ValueError("only non-negative seeds are emulated")
    hi = torch.tensor((seed >> 32) & _M32, dtype=torch.int64, device=device)
    lo = torch.tensor(seed & _M32, dtype=torch.int64, device=device)
    return hi, lo


def split(k: Key) -> Tuple[Key, Key]:
    """``jax.random.split(k)`` into two keys: the hash of the counters 0
    and 1. ``k`` may be a batch of keys of any shape."""
    k0, k1 = k
    z = torch.zeros_like(k0)
    return threefry2x32(k0, k1, z, z), threefry2x32(k0, k1, z, z + 1)


def fold_in(k: Key, data) -> Key:
    """``jax.random.fold_in(k, data)``; ``data`` may be a tensor of
    non-negative 32-bit integers, giving one folded key per element."""
    k0, k1 = k
    data = torch.as_tensor(data, dtype=torch.int64, device=k0.device) & _M32
    return threefry2x32(k0, k1, torch.zeros_like(data), data)


def random_bits(k: Key, n: int) -> torch.Tensor:
    """32-bit random words of shape ``k.shape + (n,)``: the partitionable
    ``bits1 ^ bits2`` of the hashed counters ``0..n-1``."""
    k0, k1 = k
    cnt = torch.arange(n, dtype=torch.int64, device=k0.device)
    b0, b1 = threefry2x32(k0[..., None], k1[..., None], torch.zeros_like(cnt), cnt)
    return b0 ^ b1


def uniform(k: Key, n: int) -> torch.Tensor:
    """``jax.random.uniform(k, (n,))`` in float32 over ``[0, 1)``."""
    bits = (random_bits(k, n) >> 9) | 0x3F800000
    f = bits.to(torch.int32).view(torch.float32)
    return f - 1.0


def randint(k: Key, n: int, minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint(k, (n,), minval, maxval)`` with int32 output."""
    ka, kb = split(k)
    higher = random_bits(ka, n)
    lower = random_bits(kb, n)
    span = (maxval - minval) & _M32 if maxval > minval else 1
    mult = (1 << 16) % span
    mult = ((mult * mult) & _M32) % span     # uint32 product wraps
    off = (((higher % span) * mult) & _M32) + (lower % span)
    off = (off & _M32) % span
    return (off + minval).to(torch.int32)
