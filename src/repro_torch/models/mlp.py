"""Feed-forward blocks and RMSNorm (the port of ``repro/models/mlp.py``).

Two numerics follow JAX exactly: ``jax.nn.gelu`` defaults to the tanh
approximation, and ``rmsnorm`` scales by ``1 + scale`` (a zero-initialised
scale is the identity).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def swiglu(x: torch.Tensor, wg: torch.Tensor, wu: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """x (..., D) -> (..., D) via silu(x wg) * (x wu) wd."""
    return (F.silu(x @ wg) * (x @ wu)) @ wd


def gelu_mlp(x: torch.Tensor, wg: torch.Tensor, wd: torch.Tensor) -> torch.Tensor:
    """Non-gated 2-matrix FFN (starcoder2 / musicgen style)."""
    return F.gelu(x @ wg, approximate="tanh") @ wd


def mlp_apply(x: torch.Tensor, params, variant: str) -> torch.Tensor:
    if variant == "swiglu":
        return swiglu(x, params["wg"], params["wu"], params["wd"])
    return gelu_mlp(x, params["wg"], params["wd"])


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.float()
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    out = x32 * torch.rsqrt(var + eps) * (1.0 + scale.float())
    return out.to(x.dtype)
