"""``ssm``: a pre-norm Mamba-1 block (causal depthwise conv, SiLU, selective
scan, SiLU gate) with its residual. In the program the conv, its bias and
the SiLU are one ``causal_conv1d`` launch and the scan one ``mamba_scan``
launch."""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from thriftbench.reference.model import mm, rmsnorm

BATCH_COUPLED = False


def spec(m: Dict):
    D, Din, N, R, K = m["d_model"], m["d_inner"], m["ssm_state"], m["ssm_dt_rank"], m["ssm_conv"]
    return [("ln", (D,), "zeros", 0), ("w_in", (D, 2 * Din), "mat", D),
            ("conv_w", (Din, K), "mat", K), ("conv_b", (Din,), "zeros", 0),
            ("w_x", (Din, R + 2 * N), "mat", Din), ("w_dt", (R, Din), "mat", R),
            ("b_dt", (Din,), "b_dt", 0), ("a_log", (Din, N), "a_log", 0),
            ("d_skip", (Din,), "ones", 0), ("w_out", (Din, D), "mat", Din)]


def residual_depth(m: Dict) -> int:
    return m["num_layers"]


def mamba(x: torch.Tensor, p: Dict, m: Dict, precision: str) -> torch.Tensor:
    B, S, _ = x.shape
    Din, N, R, K = m["d_inner"], m["ssm_state"], m["ssm_dt_rank"], m["ssm_conv"]
    xz = mm(x, p["w_in"], precision)
    xs, z = xz[..., :Din], xz[..., Din:]
    w = p["conv_w"].float()                                          # (Din, K)
    padded = F.pad(xs, (0, 0, K - 1, 0))                             # zeros before t = 0
    conv = sum(padded[:, i:i + S] * w[:, i] for i in range(K)) + p["conv_b"].float()
    u = F.silu(conv)
    proj = mm(u, p["w_x"], precision)
    dt = F.softplus(mm(proj[..., :R], p["w_dt"], precision) + p["b_dt"].float())
    Bm, Cm = proj[..., R:R + N], proj[..., R + N:]
    A = -torch.exp(p["a_log"].float())                               # (Din, N)
    h = torch.zeros((B, Din, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        h = torch.exp(dt[:, t, :, None] * A) * h + (dt[:, t] * u[:, t])[..., None] * Bm[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, Cm[:, t]))
    y = torch.stack(ys, dim=1) + u * p["d_skip"].float()
    return mm(y * F.silu(z), p["w_out"], precision)


def forward(h: torch.Tensor, p: Dict, m: Dict, precision: str, segments) -> torch.Tensor:
    return h + mamba(rmsnorm(h, p["ln"], m["norm_eps"]), p, m, precision)


def flops(m: Dict, S: int) -> int:
    """The projections, the conv's taps, and the scan: 7 a (t, d, n) and 3 a
    (t, d) (``rooflines/mamba_scan.py``)."""
    D, Din, N, R, K = m["d_model"], m["d_inner"], m["ssm_state"], m["ssm_dt_rank"], m["ssm_conv"]
    return S * (2 * D * 2 * Din + 2 * K * Din + 2 * Din * (R + 2 * N)
                + 2 * R * Din + 7 * Din * N + 3 * Din + 2 * Din * D)


def launches(m: Dict) -> Dict[str, int]:
    return {"mamba_scan": 1, "causal_conv1d": 1}
