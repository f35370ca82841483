"""Dispatching wrappers for the port's kernels, with launch counters.

For a tensor on the CPU each wrapper computes the kernel's plain PyTorch
version (:mod:`repro_torch.kernels.ref`). For a CUDA tensor it launches the
hand-written CUDA kernel, building it on first use, or raises: there is no
fallback from the card to the plain version. ``<wrapper>.launches`` counts
the kernel launches, and nothing else increments it.

The four model kernels (``flash_attention``, ``rglru_scan``,
``mamba_scan``, ``causal_conv1d``) run on CUDA tensors as a
:class:`KernelFunction`, so
training differentiates through them: the forward launches the kernel and
the backward differentiates the plain version, recomputed on the saved
inputs. The JAX package has no backward kernel either (its
``pl.pallas_call`` sites are all forward; ``jax.grad`` differentiates the
pure-jnp oracles). On the CPU the plain versions run under ordinary
autograd.

On the ``meta`` device (shapes and dtypes only: the launch tools' specs
and dry run) the two scans return empty outputs of the shapes and dtypes
the kernel gives, ``h_last`` included: nothing is computed there, so
nothing is launched or counted, and the plain scans' loops over time are
not run either. ``causal_conv1d`` on meta runs its plain version, a few
elementwise ops that compute nothing there. Attention on meta never
reaches ``flash_attention`` (``models/attention.py`` sends it only CUDA
tensors; meta takes the plain blocked attention). The other kernels take
no meta tensor.

No wrapper takes a ``DTensor`` (a sharded tensor of
``torch.distributed.tensor``): its ``data_ptr`` is not its shard's memory,
and the plain versions would compute on it through the ``DTensor``
dispatch, densifying where they need to. Each wrapper and
:class:`KernelFunction` raise a ``TypeError`` instead; a sharded model
hands its kernels the whole tensors it gathered
(:func:`repro_torch.distributed.unshard`).
"""
from __future__ import annotations

import torch

from repro_torch.distributed.sharding import is_distributed

from . import belief_aggregate as _belief_aggregate
from . import causal_conv1d as _causal_conv1d
from . import flash_attention as _flash_attention
from . import mamba_scan as _mamba_scan
from . import mc_correctness as _mc_correctness
from . import ref
from . import rglru_scan as _rglru_scan


def _refuse_distributed(*tensors) -> None:
    for t in tensors:
        if is_distributed(t):
            raise TypeError("a kernel wrapper was handed a DTensor: kernels take whole local "
                            "tensors (gather a sharded parameter with "
                            "repro_torch.distributed.unshard first)")


def _device_kind(t: torch.Tensor) -> str:
    kind = t.device.type
    if kind not in ("cpu", "cuda"):
        raise ValueError(f"kernels run on cpu (plain version) or cuda, not {kind}")
    return kind


def belief_aggregate(responses, log_weights, empty_belief, num_classes: int):
    """Batched router aggregation: ``(log_beliefs (B, K) f32, predictions
    (B,) int32)``. ``log_weights`` may be (B, M) or (M,), ``empty_belief``
    a scalar or (B,); responses of -1 mark arms not invoked."""
    _refuse_distributed(responses, log_weights, empty_belief)
    if _device_kind(responses) == "cpu":
        return ref.belief_aggregate_ref(responses, log_weights, empty_belief, num_classes)
    B, M = responses.shape
    dev = responses.device
    w = torch.as_tensor(log_weights, dtype=torch.float32, device=dev).expand(B, M)
    empty = torch.as_tensor(empty_belief, dtype=torch.float32, device=dev).expand(B)
    out = _belief_aggregate.launch(
        responses.to(torch.int32).contiguous(), w.contiguous(), empty.contiguous(),
        num_classes,
    )
    belief_aggregate.launches += 1
    return out


belief_aggregate.launches = 0


def mc_correctness(responses, masks, log_weights, empty_belief, num_classes: int):
    """(C,) f32 xi estimates of C candidate masks over one pool's shared
    (T, L) draws; ``empty_belief`` is a scalar."""
    _refuse_distributed(responses, masks, log_weights, empty_belief)
    if _device_kind(responses) == "cpu":
        return ref.mc_correctness_ref(responses, masks, log_weights, empty_belief, num_classes)
    dev = responses.device
    f32 = lambda t: torch.as_tensor(t, dtype=torch.float32, device=dev).contiguous()
    out = _mc_correctness.launch(
        responses.to(torch.int32).contiguous(), f32(masks), f32(log_weights),
        f32(empty_belief).reshape(1), num_classes,
    )
    mc_correctness.launches += 1
    return out


mc_correctness.launches = 0


def mc_correctness_grouped(responses, masks, log_weights, empty_belief,
                           valid, theta, num_classes: int):
    """(G, C) f32 xi estimates over the planner's stacked (G, theta, L)
    draws; ragged thetas are carried by the ``valid`` mask."""
    _refuse_distributed(responses, masks, log_weights, empty_belief, valid, theta)
    if _device_kind(responses) == "cpu":
        return ref.mc_correctness_grouped_ref(
            responses, masks, log_weights, empty_belief, valid, theta, num_classes,
        )
    dev = responses.device
    f32 = lambda t: torch.as_tensor(t, dtype=torch.float32, device=dev).contiguous()
    out = _mc_correctness.launch_grouped(
        responses.to(torch.int32).contiguous(), f32(masks), f32(log_weights),
        f32(empty_belief), f32(valid), f32(theta), num_classes,
    )
    mc_correctness_grouped.launches += 1
    return out


mc_correctness_grouped.launches = 0


class KernelFunction(torch.autograd.Function):
    """A hand-written kernel's forward with its plain version's gradient.

    ``KernelFunction.apply(launch, plain, kwargs, *inputs)`` returns
    ``launch(*inputs, **kwargs)``. Its backward runs ``plain(*inputs,
    **kwargs)`` again on the saved inputs under ``torch.enable_grad()`` and
    returns ``torch.autograd.grad`` of it for the upstream gradients given
    (an output whose gradient is not needed is left out), so the input
    gradients are exactly those of the plain version's own autograd.
    ``inputs`` may hold ``None``.
    """

    @staticmethod
    def forward(ctx, launch, plain, kwargs, *inputs):
        _refuse_distributed(*inputs)
        ctx.plain, ctx.kwargs = plain, kwargs
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(*inputs)
        return launch(*inputs, **kwargs)

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[3:]
        # a named range, so a profile can tell this backward's device time
        with torch.profiler.record_function(f"{ctx.plain.__name__} backward"):
            with torch.enable_grad():
                leaves = [None if t is None else t.detach().requires_grad_(n)
                          for t, n in zip(ctx.saved_tensors, need)]
                outs = ctx.plain(*leaves, **ctx.kwargs)
            outs = outs if isinstance(outs, tuple) else (outs,)
            pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
            wrt = [t for t, n in zip(leaves, need) if n]
            got = [None] * len(wrt)
            if pairs and wrt:
                got = list(torch.autograd.grad([o for o, _ in pairs], wrt,
                                               [g for _, g in pairs], allow_unused=True))
        got.reverse()
        return (None, None, None, *(got.pop() if n else None for n in need))


def _launch_flash(q, k, v, causal, window):
    out = _flash_attention.launch(q, k, v, causal=causal, window=window)
    flash_attention.launches += 1
    return out


def flash_attention(q, k, v, causal: bool = True, window: int = 0):
    """(B, S, H, hd) x (B, T, G, hd) k x (B, T, G, dv) v -> (B, S, H, dv)
    causal / windowed GQA attention in q's dtype (f32 or bf16), 1 <= hd <=
    256, dv <= hd. On the card a v narrower than q/k (latent attention: q/k
    192, v 128) is zero-padded to hd, written once from whatever strides v
    has, and the output is the first dv columns of the kernel's (a view):
    one launch still, the padded columns adding products and bytes. The
    pad and the slice are differentiable, so the backward sees the padded
    launch's plain version."""
    _refuse_distributed(q, k, v)
    dv, hd = v.shape[-1], q.shape[-1]
    if dv > hd:
        raise ValueError(f"flash_attention takes v's head dim {dv} at most q/k's {hd}")
    if _device_kind(q) == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, window=window)
    if dv < hd:
        v = torch.nn.functional.pad(v, (0, hd - dv))
    out = KernelFunction.apply(_launch_flash, ref.flash_attention_ref,
                               {"causal": causal, "window": window},
                               q.contiguous(), k.contiguous(), v.contiguous())
    return out if dv == hd else out[..., :dv]


flash_attention.launches = 0


def _launch_rglru(log_a, gated, h0):
    out = _rglru_scan.launch(log_a, gated, h0)
    rglru_scan.launches += 1
    return out


def rglru_scan(log_a, gated, h0):
    """Diagonal linear recurrence in f32: ``(h (B, S, D), h_last (B, D))``."""
    _refuse_distributed(log_a, gated, h0)
    f32 = lambda t: t.to(torch.float32).contiguous()
    if log_a.device.type == "meta":
        return (log_a.new_empty(log_a.shape, dtype=torch.float32),
                log_a.new_empty(h0.shape, dtype=torch.float32))
    if _device_kind(log_a) == "cpu":
        return ref.rglru_scan_ref(f32(log_a), f32(gated), f32(h0))
    return KernelFunction.apply(_launch_rglru, ref.rglru_scan_ref, {},
                                f32(log_a), f32(gated), f32(h0))


rglru_scan.launches = 0


def _launch_mamba(x, dt, A, Bmat, Cmat, Dskip, h0):
    out = _mamba_scan.launch(x, dt, A, Bmat, Cmat, Dskip, h0)
    mamba_scan.launches += 1
    return out


def mamba_scan(x, dt, A, Bmat, Cmat, Dskip, h0=None):
    """Fused Mamba-1 selective scan: ``(y (B, S, Din) in x's dtype, h_last
    (B, Din, N) f32)``. x, B and C in the block's dtype (bf16 or f32; B and
    C may be strided views), dt in f32 as the block gives it (another
    float dtype is widened here, exactly), the recurrence in f32,
    ``h0=None`` a zero state. On the card nothing is cast or copied around
    the launch of the block's own tensors."""
    _refuse_distributed(x, dt, A, Bmat, Cmat, Dskip, h0)
    if x.device.type == "meta":
        return (x.new_empty(x.shape),
                x.new_empty((x.shape[0], x.shape[2], A.shape[1]), dtype=torch.float32))
    if _device_kind(x) == "cpu":
        return ref.mamba_scan_ref(x, dt, A, Bmat, Cmat, Dskip, h0)
    return KernelFunction.apply(
        _launch_mamba, ref.mamba_scan_ref, {},
        x.contiguous(), dt.to(torch.float32).contiguous(), A.to(torch.float32).contiguous(),
        Bmat, Cmat, Dskip, None if h0 is None else h0.to(torch.float32).contiguous(),
    )


mamba_scan.launches = 0


def _launch_conv(x, w, b, state, silu):
    out = _causal_conv1d.launch(x, w, b, state, silu=silu)
    causal_conv1d.launches += 1
    return out


def causal_conv1d(x, w, b, state=None, silu: bool = False):
    """Depthwise causal conv along time with its bias, and the SiLU where
    ``silu``: y (B, S, D) in x's dtype from x (B, S, D), w (D, K), b (D,)
    and ``state`` (B, K-1, D), the K-1 inputs before x (None: zeros). On
    the card x goes in as it is (unit stride over channels, any batch and
    timestep strides: the block's split view) and one launch computes it;
    the returned conv state is the caller's (``models/ssm.py``)."""
    _refuse_distributed(x, w, b, state)
    if x.device.type == "meta" or _device_kind(x) == "cpu":
        return ref.causal_conv1d_ref(x, w, b, state, silu=silu)
    return KernelFunction.apply(_launch_conv, ref.causal_conv1d_ref, {"silu": silu},
                                x, w.contiguous(), b.contiguous(),
                                None if state is None else state.contiguous())


causal_conv1d.launches = 0


def reset_launch_counts() -> None:
    """Set every kernel's launch counter to 0."""
    belief_aggregate.launches = 0
    mc_correctness.launches = 0
    mc_correctness_grouped.launches = 0
    flash_attention.launches = 0
    rglru_scan.launches = 0
    mamba_scan.launches = 0
    causal_conv1d.launches = 0
