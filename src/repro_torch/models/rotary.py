"""Rotary position embeddings (the port of ``repro/models/rotary.py``).

RoPE here rotates the two *halves* of each head vector against each other
(``x[:hd/2]`` with ``x[hd/2:]``), not interleaved pairs, as the JAX package
does.
"""
from __future__ import annotations

import torch


def rope_frequencies(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    """(head_dim/2,) f32 inverse frequencies ``1 / theta**(i / half)``."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0) -> torch.Tensor:
    """Rotate the halves of each feature vector by position-dependent angles.

    Args:
      x: (B, S, H, hd) queries or keys.
      positions: (B, S) or (S,) absolute token positions.
    """
    hd = x.shape[-1]
    inv = rope_frequencies(hd, theta, device=x.device)               # (hd/2,)
    pos = torch.as_tensor(positions, device=x.device).to(torch.float32)
    if pos.dim() == 1:
        pos = pos[None, :]
    angles = pos[:, :, None] * inv[None, None, :]                   # (B, S, hd/2)
    cos = torch.cos(angles)[:, :, None, :]                          # (B, S, 1, hd/2)
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    rot = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return rot.to(x.dtype)
