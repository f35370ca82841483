"""Tier-1 runs under the thriftlint tracer-leak guard.

`jax.check_tracer_leaks` is enabled for the whole suite (the runtime
counterpart of the static jit-purity rule): any test that smuggles a
tracer into host state fails immediately instead of corrupting a later
test through a stale reference.  Opt out with THRIFTLINT_TRACER_GUARD=0
(e.g. for profiling runs — the guard adds gc-based bookkeeping to every
trace).
"""
from repro.analysis import install_tracer_guard

TRACER_GUARD_INSTALLED = install_tracer_guard()


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA device (a hand-written kernel has no CPU mode); "
        "skips with a reason where there is none",
    )
