"""Monte-Carlo estimation of the correctness probability (Lemma 4), in torch.

The PyTorch port of ``repro/core/mc.py``. The estimator draws ``theta``
synthetic observations of the *whole pool* once (common random numbers) and
evaluates any candidate subset over those shared draws; CRN pairs the greedy
comparisons and means one sample serves an entire SurGreedyLLM run.

The draws come from :mod:`repro_torch.core.prng`, a torch emulation of the
reference's ``threefry2x32`` stream, so they are the reference's bit for
bit. The grouped evaluators keep the reference's *bit-stability*: every
floating-point reduction is either exact (integer-valued tie counts) or an
elementwise chain in a fixed order, so group g's xi values are bitwise
identical whether it is evaluated alone or inside a padded batch — and
bitwise identical to the JAX package's.

Differences from the reference: no ``jit`` (torch runs eagerly, one IEEE op
per statement), tensors live on an explicit ``device``, and the host-side
belief-table loops of the reference's ``GroupedXiEstimator.__call__`` are
the mask chain of :func:`_masked_xi_core` itself (the reference documents
the two as the same operand sequence).

:func:`xi_from_responses` and :class:`McXiEstimator` (the CRN estimator of
one pool, behind GreedyLLM on xi) use that exact form too: the group core
at G=1 over every draw. It differs from the reference's f32 mean by at most
an f32 rounding, and it is the plain version the ``mc_correctness`` kernel
equals bit for bit.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch

from . import prng
from .belief import empty_log_belief, log_weight
from .types import clip_probs

TIE_TOL = 1e-6
THETA_BUCKET = 256      # the reference's tile: both packages stage equal (G, T, L) draws


def theta_for(eps: float, delta: float, p_star: float, num_arms: int) -> int:
    """theta = (8 + 2 eps) / (eps^2 p*) * ln(2 L^2 / delta)  (Algorithm 3)."""
    p_star = max(p_star, 1e-6)
    theta = (8.0 + 2.0 * eps) / (eps * eps * p_star) * math.log(2.0 * num_arms * num_arms / delta)
    return int(math.ceil(theta))


def _draw_rows(key: prng.Key, num_arms: int, num_classes: int, theta: int):
    """(theta, L) uniform + wrong-class draws whose row ``t`` depends only
    on ``(key, t)`` (per-row ``fold_in``), never on ``theta`` — so the
    grouped sampler can draw one ``(theta_max, L)`` tensor and hand every
    group its own prefix."""
    ku, kc = prng.split(key)
    t = torch.arange(theta, dtype=torch.int64, device=key[0].device)
    u = prng.uniform(prng.fold_in(ku, t), num_arms)
    wrong = prng.randint(prng.fold_in(kc, t), num_arms, 1, num_classes)
    return u, wrong


def sample_pool_responses(key: prng.Key, p, num_classes: int, theta: int) -> torch.Tensor:
    """(theta, L) int32 responses of every arm, ground truth = class 0.

    Arm i answers 0 w.p. p_i, else uniformly one of the K-1 wrong classes.
    """
    p = torch.as_tensor(p, dtype=torch.float32, device=key[0].device)
    u, wrong = _draw_rows(key, p.shape[0], num_classes, theta)
    return torch.where(u < p[None, :], 0, wrong).to(torch.int32)


def sample_pool_responses_grouped(key: prng.Key, ps, num_classes: int, theta: int) -> torch.Tensor:
    """(G, theta, L) responses for G groups sharing one CRN draw tensor.

    Group g's rows ``[:theta_g]`` are bitwise identical to
    ``sample_pool_responses(key, ps[g], num_classes, theta_g)``.
    """
    ps = torch.as_tensor(ps, dtype=torch.float32, device=key[0].device)
    u, wrong = _draw_rows(key, ps.shape[1], num_classes, theta)
    return torch.where(u[None] < ps[:, None, :], 0, wrong[None]).to(torch.int32)


def xi_from_responses(responses, masks, log_weights, empty_belief,
                      num_classes: int) -> torch.Tensor:
    """Estimate xi for C candidate subsets from shared response draws.

    responses (T, L) int32, masks (C, L) f32 0/1, log_weights (L,) f32,
    empty_belief a scalar f32. Returns (C,) f32: the exact fractional-credit
    mean of :func:`_masked_xi_core` over all T draws, rounded once to f32.
    This is the plain version of the ``mc_correctness`` kernel.
    """
    T = responses.shape[0]
    dev = responses.device
    empty = torch.as_tensor(empty_belief, dtype=torch.float32, device=dev).reshape(1)
    valid = torch.ones((1, T), dtype=torch.float32, device=dev)
    theta = torch.full((1,), float(T), dtype=torch.float64, device=dev)
    return _masked_xi_core(
        responses[None], masks[None], log_weights[None], empty, valid, theta, num_classes,
    )[0].to(torch.float32)


class McXiEstimator:
    """Stateful CRN estimator bound to one (pool, query-class) pair.

    ``key`` is a port key (:func:`repro_torch.core.prng.key`); the draws are
    the reference's bit for bit. ``use_kernel`` scores candidates with the
    ``mc_correctness`` kernel (its plain version for a CPU ``device``).

    Usage::

        est = McXiEstimator(prng.key(0, "cuda"), p, K, theta)
        vals = est(masks)          # (C,) numpy
        x    = est.xi(indices)     # scalar
    """

    def __init__(
        self,
        key: prng.Key,
        p: np.ndarray,
        num_classes: int,
        theta: int,
        p_all: Optional[np.ndarray] = None,
        use_kernel: bool = False,
        device="cuda",
    ):
        self.device = torch.device(device)
        self.p = clip_probs(p)
        self.num_arms = int(self.p.size)
        self.num_classes = int(num_classes)
        self.theta = int(theta)
        self.use_kernel = bool(use_kernel)
        self._w = torch.as_tensor(
            log_weight(self.p, self.num_classes).astype(np.float32), device=self.device
        )
        self._empty = torch.tensor(
            empty_log_belief(self.p if p_all is None else p_all),
            dtype=torch.float32, device=self.device,
        )
        key = tuple(k.to(self.device) for k in key)
        self._responses = sample_pool_responses(
            key, self.p.astype(np.float32), self.num_classes, self.theta
        )

    def __call__(self, masks: np.ndarray) -> np.ndarray:
        masks = torch.as_tensor(
            np.atleast_2d(np.asarray(masks, np.float32)), device=self.device
        )
        if self.use_kernel:
            from repro_torch.kernels import ops as kernel_ops

            vals = kernel_ops.mc_correctness(
                self._responses, masks, self._w, self._empty, self.num_classes
            )
        else:
            vals = xi_from_responses(
                self._responses, masks, self._w, self._empty, self.num_classes
            )
        return vals.cpu().numpy()

    def xi(self, indices) -> float:
        mask = np.zeros(self.num_arms, np.float32)
        if len(indices):
            mask[np.asarray(indices, np.int64)] = 1.0
        return float(self(mask[None, :])[0])


# ---------------------------------------------------------------------------
# Grouped (batched-planner) evaluation
# ---------------------------------------------------------------------------


def bucket_size(n: int, base: int) -> int:
    """Round ``n`` up to a bucket: multiples of ``base`` up to ``4 * base``,
    powers of two beyond — the draw-tensor length policy of the reference,
    kept so both packages stage the same ``(G, theta_max, L)`` shapes."""
    n = max(1, int(n))
    if n <= 4 * base:
        return max(base, -(-n // base) * base)
    m = 4 * base
    while m < n:
        m *= 2
    return m


def _hist_from_ties(hit0: torch.Tensor, ties: torch.Tensor, num_classes: int):
    """(hit0 (..., T) bool, ties (..., T) int) -> (..., K) f32 counts of
    draws where class 0 attains the max with exactly ``j + 1`` classes tied.
    Sums of 0/1 values below 2^24: exact in any order."""
    return torch.stack(
        [(hit0 & (ties == j + 1)).to(torch.float32).sum(-1)  # thriftlint: ignore[f64-reduction] 0/1 counts below 2^24 are exact in f32 in any order
         for j in range(num_classes)],
        dim=-1,
    )


def _xi_from_ties(hit0: torch.Tensor, ties: torch.Tensor, theta: torch.Tensor,
                  num_classes: int):
    """Exact fractional-credit mean from per-draw (hit0, ties) configs.

    K <= 18 (lcm(1..K) < 2^24): each draw's credit ``1/ties`` is scaled by
    the lcm into an exact integer, summed exactly in f64 and divided once.
    Beyond that the tie-count histogram keeps exactness.
    """
    lcm = math.lcm(*range(1, num_classes + 1))
    if lcm < (1 << 24):
        # exact: ties divides the lcm, so the f32 quotient is an integer.
        # Both operands are tensors: torch turns `scalar / t` and, on CUDA,
        # `t / scalar` into a multiply by a reciprocal, which is not exact.
        num = torch.tensor(float(lcm), dtype=torch.float32, device=ties.device)
        scaled = num / torch.clamp(ties, min=1).to(torch.float32)
        credit = torch.where(hit0, scaled, torch.zeros_like(scaled))
        s = credit.to(torch.float64).sum(-1)
        return s / (theta * float(lcm))
    hist = _hist_from_ties(hit0, ties, num_classes)
    return _xi_from_hist(hist, theta, num_classes)


def _tie_histogram(disp: torch.Tensor, valid: torch.Tensor, num_classes: int):
    """Per-draw ``(hit0, ties)`` of the fractional-credit estimator.

    ``disp`` is ``(..., T, K)`` displayed log-beliefs; ``valid`` broadcasts
    over the draw axis with 0 marking padding.
    """
    mx = disp.max(dim=-1, keepdim=True).values
    is_max = disp >= mx - TIE_TOL
    ties = is_max.to(torch.int32).sum(-1)
    hit0 = is_max[..., 0] & (valid > 0)
    return hit0, ties


def _xi_from_hist(hist: torch.Tensor, theta: torch.Tensor, num_classes: int):
    """Exact tie-count histogram -> xi, in float64, as a fixed-order chain
    ``(hist_0 + hist_1 / 2 + ... ) / theta``."""
    denom = torch.arange(1, num_classes + 1, dtype=torch.float64, device=hist.device)
    acc = hist[..., 0].to(torch.float64)
    for j in range(1, num_classes):
        acc = acc + hist[..., j].to(torch.float64) / denom[j]   # tensor divisor: exact
    return acc / theta


def _masked_xi_core(responses, masks, log_weights, empty, valid, theta,
                    num_classes: int):
    """xi of C arbitrary (binary-mask) subsets per group.

    responses: (G, T, L) int32, -1 past each group's theta.
    masks:     (G, C, L) f32 0/1 subset indicators.
    log_weights: (G, L) f32; empty: (G,) f32; valid: (G, T) f32;
    theta: (G,) f64. Returns (G, C) f64.

    Beliefs accumulate as an explicit chain over the arm axis in ascending
    index order, so per-group values are batching-invariant.
    """
    G, T, L = responses.shape
    K = num_classes
    C = masks.shape[1]
    oh = responses[..., None] == torch.arange(K, dtype=responses.dtype, device=responses.device)
    raw = torch.zeros((G, C, T, K), dtype=torch.float32, device=responses.device)
    cnt = torch.zeros((G, C, T, K), dtype=torch.int32, device=responses.device)
    for l in range(L):
        sel = (masks[:, :, l] > 0)[:, :, None, None] & oh[:, :, l, :][:, None]
        w_l = log_weights[:, l][:, None, None, None]
        raw = torch.where(sel, raw + w_l, raw)
        cnt = cnt + sel.to(torch.int32)
    disp = torch.where(cnt > 0, raw, empty[:, None, None, None])
    hit0, ties = _tie_histogram(disp, valid[:, None, :], K)
    return _xi_from_ties(hit0, ties, theta[:, None], K)


def _marginal_xi_core(resp_t, base_raw, base_cnt, log_weights, empty,
                      valid, theta, num_classes: int):
    """xi of (current set ∪ {l}) for every arm l, per group.

    The greedy hot path: the current set's belief table ``(base_raw,
    base_cnt)`` is extended by one arm's response column. A candidate moves
    only ONE class's belief per draw, so the new max and tie count come from
    the base's exact top-2 and per-class threshold counts — all selections
    exact, hence bitwise the naive per-candidate evaluation.

    resp_t: (G, L, T) int32; base_raw: (G, T, K) f32; base_cnt: (G, T, K)
    int32. Returns (G, L) f64.
    """
    K = num_classes
    G, L, T = resp_t.shape
    base_disp = torch.where(base_cnt > 0, base_raw, empty[:, None, None])

    # exact top-2 of the base display, plus the max's multiplicity
    m1 = torch.full((G, T), -math.inf, dtype=base_disp.dtype, device=base_disp.device)
    m2 = m1
    c1 = torch.zeros((G, T), dtype=torch.int32, device=base_disp.device)
    for k in range(K):
        v = base_disp[:, :, k]
        gt = v > m1
        eq = v == m1
        m2 = torch.where(gt, m1, torch.maximum(m2, v))
        c1 = torch.where(gt, 1, torch.where(eq, c1 + 1, c1)).to(torch.int32)
        m1 = torch.where(gt, v, m1)

    is_mod = resp_t >= 0                                  # -1 = no response
    kc = torch.clamp(resp_t, min=0)                       # (G, L, T)
    rawstar = base_raw[:, None, :, 0].expand(G, L, T)
    dispstar = base_disp[:, None, :, 0].expand(G, L, T)
    for k in range(1, K):
        hit = kc == k
        rawstar = torch.where(hit, base_raw[:, None, :, k], rawstar)
        dispstar = torch.where(hit, base_disp[:, None, :, k], dispstar)
    # the modified class's new value; an unmodified draw keeps its display
    a = torch.where(is_mod, rawstar + log_weights[:, :, None], dispstar)
    excl = torch.where(
        dispstar == m1[:, None, :],
        torch.where(c1[:, None, :] >= 2, m1[:, None, :], m2[:, None, :]),
        m1[:, None, :],
    )                                                     # exact max over k != k*
    mx = torch.maximum(a, excl)
    thr = mx - TIE_TOL
    n_ge = torch.zeros((G, L, T), dtype=torch.int32, device=resp_t.device)
    for k in range(K):
        n_ge = n_ge + (base_disp[:, :, k][:, None, :] >= thr).to(torch.int32)
    ties = (a >= thr).to(torch.int32) + n_ge - (dispstar >= thr).to(torch.int32)
    disp0 = torch.where(is_mod & (kc == 0), a, base_disp[:, :, 0][:, None, :])
    hit0 = (disp0 >= thr) & (valid[:, None, :] > 0)
    return _xi_from_ties(hit0, ties, theta[:, None], K)


def _tables_xi_core(base_raw, base_cnt, empty, valid, theta, num_classes: int):
    """xi from prebuilt (G, C, T, K) belief tables -> (G, C) f64: the
    empty-class display, the tie histogram and the combine."""
    disp = torch.where(base_cnt > 0, base_raw, empty[:, None, None, None])
    hit0, ties = _tie_histogram(disp, valid[:, None, :], num_classes)
    return _xi_from_ties(hit0, ties, theta[:, None], num_classes)


# the reference's public names of the two xi cores (jitted there; eager here)
xi_from_responses_grouped = _masked_xi_core
xi_marginal_grouped = _marginal_xi_core


class GroupedXiEstimator:
    """The CRN estimator reshaped over G groups for the planner.

    Each group g gets exactly the draws ``sample_pool_responses(key, p_g, K,
    theta_g)`` with the *shared* key, stacked into one ``(G, theta_max, L)``
    int32 tensor on ``device`` (padded with -1 responses and a 0 ``valid``
    mask past each group's own theta; ``theta_max`` rounded up by
    :func:`bucket_size`).

    Usage::

        est = GroupedXiEstimator(key, ps, K, thetas, device="cuda")
        vals = est(masks)                               # (G, C) f64 tensor
        gains = est.marginal(base_raw, base_cnt)        # (G, L) f64 tensor
    """

    def __init__(
        self,
        key: prng.Key,
        ps: np.ndarray,
        num_classes: int,
        thetas,
        p_all: Optional[np.ndarray] = None,
        use_kernel: bool = False,
        device="cuda",
    ):
        ps = clip_probs(np.atleast_2d(np.asarray(ps, np.float64)))
        G, L = ps.shape
        self.device = torch.device(device)
        self.ps = ps
        self.num_groups = G
        self.num_arms = L
        self.num_classes = int(num_classes)
        self.use_kernel = bool(use_kernel)
        thetas = np.broadcast_to(np.asarray(thetas, np.int64), (G,))
        self.thetas = thetas
        Tp = bucket_size(int(thetas.max()), THETA_BUCKET)
        key = tuple(k.to(self.device) for k in key)
        resp = sample_pool_responses_grouped(key, ps.astype(np.float32), self.num_classes, Tp)
        valid = np.arange(Tp)[None, :] < thetas[:, None]
        self.valid = torch.as_tensor(valid.astype(np.float32), device=self.device)
        self.responses = torch.where(self.valid[:, :, None] > 0, resp, -1).to(torch.int32)
        # candidate-major layout for the greedy's marginal evaluation
        self.responses_t = self.responses.transpose(1, 2).contiguous()
        # host numpy, as the reference computes them (elementwise per group)
        base = ps if p_all is None else clip_probs(
            np.broadcast_to(np.atleast_2d(np.asarray(p_all, np.float64)), (G, L))
        )
        p_min = np.min(clip_probs(base), axis=1)
        empty = (np.log(p_min) - np.log(2.0) - np.log1p(-p_min)).astype(np.float32)
        self.log_weights = torch.as_tensor(
            log_weight(ps, self.num_classes).astype(np.float32), device=self.device
        )
        self.empty = torch.as_tensor(empty, device=self.device)
        self.theta_f = torch.as_tensor(thetas.astype(np.float64), device=self.device)
        # the kernel's f32 theta, cast once (integers below 2^24: exact)
        self.theta_f32 = self.theta_f.to(torch.float32)

    def __call__(self, masks) -> torch.Tensor:
        """(G, C, L) binary masks -> (G, C) xi estimates (f64 tensor)."""
        masks = torch.as_tensor(np.asarray(masks, np.float32), device=self.device)
        if self.use_kernel:
            from repro_torch.kernels import ops as kernel_ops

            vals = kernel_ops.mc_correctness_grouped(
                self.responses, masks, self.log_weights, self.empty,
                self.valid, self.theta_f32, self.num_classes,
            )
            return vals.to(torch.float64)
        return _masked_xi_core(
            self.responses, masks, self.log_weights, self.empty, self.valid,
            self.theta_f, self.num_classes,
        )

    def marginal(self, base_raw: torch.Tensor, base_cnt: torch.Tensor) -> torch.Tensor:
        """(G, T, K) current-set belief tables -> (G, L) xi of set ∪ {l}."""
        return _marginal_xi_core(
            self.responses_t, base_raw, base_cnt, self.log_weights, self.empty,
            self.valid, self.theta_f, self.num_classes,
        )

    def _accumulate(self, raw: torch.Tensor, cnt: torch.Tensor, g: int, arms) -> None:
        """Fold ``arms``' response columns of group ``g`` into one (T, K)
        belief table in the given arm order (one f32 add per draw per arm)."""
        t = int(self.thetas[g])
        rows = torch.arange(t, device=self.device)
        for l in arms:
            col = self.responses[g, :t, int(l)].to(torch.int64)
            raw[rows, col] += self.log_weights[g, int(l)]
            cnt[rows, col] += 1

    def final_xi(
        self,
        l_stars,
        s1s,
        s2s,
        s1_raw: Optional[torch.Tensor] = None,
        s1_cnt: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """xi of the three Alg. 2 candidates per group -> (G, 3) f64 tensor.

        The greedy's s1 belief table (accumulated in pick order) is reused
        as-is; the l* and s2 tables are folded in ascending arm order. The
        kernel backend evaluates the same three sets from their masks.
        """
        G = self.num_groups
        L = self.num_arms
        K = self.num_classes
        if self.use_kernel or s1_raw is None:
            masks = np.zeros((G, 3, L), np.float32)
            for g in range(G):
                masks[g, 0, int(l_stars[g])] = 1.0
                if len(s1s[g]):
                    masks[g, 1, np.asarray(s1s[g], np.int64)] = 1.0
                if len(s2s[g]):
                    masks[g, 2, np.asarray(s2s[g], np.int64)] = 1.0
            return self(masks)
        T = self.responses.shape[1]
        raw = torch.zeros((G, 3, T, K), dtype=torch.float32, device=self.device)
        cnt = torch.zeros((G, 3, T, K), dtype=torch.int32, device=self.device)
        raw[:, 1] = s1_raw
        cnt[:, 1] = s1_cnt
        for g in range(G):
            self._accumulate(raw[g, 0], cnt[g, 0], g, [int(l_stars[g])])
            self._accumulate(raw[g, 2], cnt[g, 2], g, sorted(int(a) for a in s2s[g]))
        return _tables_xi_core(raw, cnt, self.empty, self.valid, self.theta_f, K)
