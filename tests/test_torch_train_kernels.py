"""Gradients through the three model kernels.

On a CUDA tensor ``ops.flash_attention``, ``ops.rglru_scan`` and
``ops.mamba_scan`` run as ``ops.KernelFunction``: the forward launches the
hand-written kernel, the backward differentiates the plain version on the
saved inputs. Here on the CPU the Function is driven with the plain
version standing in for the kernel (the CUDA launch has no CPU mode), so
its gradients must equal the plain version's own autograd bitwise; the
``cuda``-marked tests do the same with the real kernels on a card, hold
``flash_attention`` at head dims that are not template ones, and take a
few train steps on the card against the CPU.

The ``cuda`` tests import neither ``jax`` nor ``repro``:

    THRIFTLINT_TRACER_GUARD=0 PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_train_kernels.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import flash_attention as flash_module
from repro_torch.kernels import ops, ref
from repro_torch.models import LM
from repro_torch.training import OptimizerConfig, init_train_state, make_train_step


def _randn(shape, seed, dev="cpu", dtype=torch.float32, scale=1.0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)


def _flash_args(B, S, H, G, hd, dtype, dev, seed=0):
    return (_randn((B, S, H, hd), seed, dev, dtype), _randn((B, S, G, hd), seed + 1, dev, dtype),
            _randn((B, S, G, hd), seed + 2, dev, dtype))


def _rglru_args(B, S, D, dev, seed=0):
    return (-torch.rand((B, S, D), generator=torch.Generator(device=dev).manual_seed(seed),
                        device=dev), _randn((B, S, D), seed + 1, dev), _randn((B, D), seed + 2, dev))


def _mamba_args(B, S, Din, N, dev, dtype=torch.float32, seed=0):
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = _randn((B, S, Din), seed + 1, dev, dtype)
    dt = torch.rand((B, S, Din), generator=gen, device=dev) * 0.1
    A = -torch.rand((Din, N), generator=gen, device=dev) - 0.5
    proj = _randn((B, S, 3 + 2 * N), seed + 2, dev, dtype)          # B, C: strided views
    D = _randn((Din,), seed + 3, dev)
    return x, dt, A, proj, D


def _grads(fn, inputs, upstream):
    """Input gradients of ``fn(*inputs)`` (its first output) for ``upstream``."""
    leaves = [t.detach().clone().requires_grad_() for t in inputs]
    out = fn(*leaves)
    out = out[0] if isinstance(out, tuple) else out
    return out.detach(), torch.autograd.grad(out, leaves, upstream)


def _mamba_fn(wrapper):
    def fn(x, dt, A, proj, D):
        N = A.shape[1]
        _, Bm, Cm = proj.split([3, N, N], dim=-1)
        return wrapper(x, dt, A, Bm, Cm, D, None)
    return fn


def _counted_plain(plain, calls):
    def launch(*args, **kwargs):
        calls.append(1)
        return plain(*args, **kwargs)
    return launch


def _function(launch, plain, **kwargs):
    return lambda *inputs: ops.KernelFunction.apply(launch, plain, kwargs, *inputs)


@pytest.mark.parametrize("kernel", ["flash_attention", "rglru_scan", "mamba_scan"])
def test_kernel_function_grads_equal_the_plain_versions(kernel):
    calls = []
    if kernel == "flash_attention":
        inputs = _flash_args(2, 9, 4, 2, 12, torch.float32, "cpu")
        plain = lambda q, k, v: ref.flash_attention_ref(q, k, v, window=4)
        fn = _function(_counted_plain(ref.flash_attention_ref, calls), ref.flash_attention_ref,
                       causal=True, window=4)
    elif kernel == "rglru_scan":
        inputs = _rglru_args(2, 7, 5, "cpu")
        plain = ref.rglru_scan_ref
        fn = _function(_counted_plain(ref.rglru_scan_ref, calls), ref.rglru_scan_ref)
    else:
        inputs = _mamba_args(2, 7, 6, 4, "cpu")
        plain = _mamba_fn(ref.mamba_scan_ref)
        fn = _mamba_fn(_function(_counted_plain(ref.mamba_scan_ref, calls), ref.mamba_scan_ref))
    out = plain(*inputs)
    upstream = _randn((out[0] if isinstance(out, tuple) else out).shape, 99)
    want_y, want = _grads(plain, inputs, upstream)
    got_y, got = _grads(fn, inputs, upstream)
    assert calls == [1]                                  # the forward ran the stand-in once
    assert torch.equal(got_y, want_y)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with torch.inference_mode():                         # serving: no graph, one launch
        fn(*inputs)
    assert calls == [1, 1]


def test_kernel_function_skips_inputs_without_grad():
    q, k, v = _flash_args(1, 5, 2, 1, 8, torch.float32, "cpu")
    q.requires_grad_()
    out = ops.KernelFunction.apply(ref.flash_attention_ref, ref.flash_attention_ref,
                                   {"causal": True, "window": 0}, q, k, v)
    (gq,) = torch.autograd.grad(out.sum(), [q])
    want = torch.autograd.grad(ref.flash_attention_ref(q, k, v).sum(), [q])[0]
    assert torch.equal(gq, want)


def test_launch_helpers_count_their_launches(monkeypatch):
    """Each wrapper's launch helper adds one to its counter per launch (the
    kernel replaced by its plain version, as a CPU tensor cannot launch)."""
    monkeypatch.setattr(ops._flash_attention, "launch", ref.flash_attention_ref)
    monkeypatch.setattr(ops._rglru_scan, "launch", ref.rglru_scan_ref)
    monkeypatch.setattr(ops._mamba_scan, "launch", ref.mamba_scan_ref)
    monkeypatch.setattr(ops._causal_conv1d, "launch", ref.causal_conv1d_ref)
    ops.reset_launch_counts()
    ops._launch_flash(*_flash_args(1, 4, 2, 1, 8, torch.float32, "cpu"), causal=True, window=0)
    ops._launch_rglru(*_rglru_args(1, 3, 4, "cpu"))
    x, dt, A, proj, D = _mamba_args(1, 3, 4, 2, "cpu")
    ops._launch_mamba(x, dt, A, proj[..., 3:5], proj[..., 5:], D, None)
    ops._launch_conv(x, torch.zeros(4, 4), torch.zeros(4), None, True)
    assert (ops.flash_attention.launches, ops.rglru_scan.launches, ops.mamba_scan.launches,
            ops.causal_conv1d.launches) == (1, 1, 1, 1)
    ops.reset_launch_counts()


def test_flash_template_head_dims():
    """The kernels are built at the template head dims and take the caller's
    hd as the row stride: f32 at any hd, bf16 at any multiple of 8 (16-byte
    pieces); only a bf16 hd that is not a multiple of 8 is padded, to the
    next multiple of 8."""
    hds = (1, 8, 12, 16, 17, 24, 40, 64, 65, 80, 96, 112, 200, 256)
    assert [flash_module.template_hd(h) for h in hds] == [
        16, 16, 16, 16, 32, 32, 64, 64, 128, 128, 128, 128, 256, 256]
    assert [flash_module.kernel_hd(h, torch.float32) for h in hds] == list(hds)
    assert [flash_module.kernel_hd(h, torch.bfloat16) for h in hds] == [
        8, 8, 16, 16, 24, 24, 40, 64, 72, 80, 96, 112, 200, 256]
    for bad in (0, 257):
        for fn in (flash_module.template_hd, lambda h: flash_module.kernel_hd(h, torch.bfloat16)):
            with pytest.raises(ValueError, match="1 <= hd <= 256"):
                fn(bad)


# ---------------------------------------------------------------------------
# On a CUDA card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [("flash bf16", 2, 70, 9, 3, 64), ("flash f32 hd 12", 2, 37, 4, 2, 12),
                                  ("rglru", 3, 24, 64), ("mamba f32", 2, 24, 128, 8),
                                  ("mamba bf16", 2, 24, 128, 16)])
def test_autograd_functions_match_the_plain_versions_on_the_card(cuda, case):
    name = case[0]
    if name.startswith("flash"):
        dtype = torch.bfloat16 if "bf16" in name else torch.float32
        inputs = _flash_args(*case[1:], dtype, cuda)
        wrapper, plain = ops.flash_attention, ref.flash_attention_ref
        counter = ops.flash_attention
    elif name == "rglru":
        inputs = _rglru_args(*case[1:], cuda)
        wrapper, plain, counter = ops.rglru_scan, ref.rglru_scan_ref, ops.rglru_scan
    else:
        dtype = torch.bfloat16 if "bf16" in name else torch.float32
        inputs = _mamba_args(*case[1:], cuda, dtype)
        wrapper, plain = _mamba_fn(ops.mamba_scan), _mamba_fn(ref.mamba_scan_ref)
        counter = ops.mamba_scan
    out = plain(*inputs)
    out = out[0] if isinstance(out, tuple) else out
    upstream = _randn(out.shape, 7, cuda, out.dtype)
    _, want = _grads(plain, inputs, upstream)
    before = counter.launches
    _, got = _grads(wrapper, inputs, upstream)
    torch.cuda.synchronize()
    assert counter.launches == before + 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("hd", [8, 12, 24, 40])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_at_non_template_head_dims(cuda, hd, dtype):
    q, k, v = _flash_args(2, 45, 6, 2, hd, dtype, cuda, seed=hd)
    for window in (0, 7):
        got = ops.flash_attention(q, k, v, window=window)
        want = ref.flash_attention_ref(q.float(), k.float(), v.float(), window=window)
        atol = 2e-2 if dtype == torch.bfloat16 else 2e-5
        assert got.shape == q.shape and got.dtype == dtype
        assert float((got.float() - want).abs().max()) <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["smollm-135m", "recurrentgemma-9b", "falcon-mamba-7b"])
def test_smoke_train_steps_card_vs_cpu(cuda, arch):
    """Three f32 train steps of the SMOKE config from the same weights on
    the card and on the CPU: losses within rel 1e-4, and every parameter
    gets a finite, non-zero gradient on the card."""
    cfg = dataclasses.replace(configs.get_smoke_config(arch), remat=True)
    losses = {}
    for dev in (cuda, torch.device("cpu")):
        model = LM(cfg, "cpu", seed=3).to(dev)
        params, opt = init_train_state(model)
        step = make_train_step(model, OptimizerConfig(lr=1e-3, warmup_steps=1))
        rng = np.random.default_rng(0)
        losses[dev.type] = []
        for _ in range(3):
            toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 24)))
            params, opt, m = step(params, opt, {"tokens": toks})
            losses[dev.type].append(float(m["loss"]))
        if dev.type == "cuda":
            loss, _ = model.loss({"tokens": toks})
            grads = torch.autograd.grad(loss, list(params.values()))
            for name, g in zip(params, grads):
                assert bool(torch.isfinite(g).all()) and float(g.abs().max()) > 0, name
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
