"""thriftlint for the port: static analysis of the contracts the port's
bitwise and parity tests rely on.

An AST/call-graph walker (`walker.Project`) resolves the code reachable
from the port's device-plane roots (the counterparts of the JAX package's
jitted entry points, the methods of every ``torch.autograd.Function``,
every caller of a kernel's ``launch*``), and four rule passes enforce:

* ``prng-discipline`` — single-use CRN keys through ``core/prng.py``, and
  no global RNG anywhere in the package;
* ``f64-reduction`` — explicit float64 (or exact) accumulation on the
  device planes of ``core/`` and ``serving/``;
* ``kernel-contract`` — a plain version behind every kernel wrapper, no
  fallback from the card to it, ``--fmad=false`` for every library;
* ``tf32-off`` — nothing turns TF32 on (the MoE router and every f32
  comparison rely on it).

Suppressions use the JAX package's grammar, ``# thriftlint: ignore[rule]
reason``; a suppression without a rule list or a reason is a finding.

No counterpart by design: ``jit-purity``, ``recompile-risk`` and
``donation-contract`` (the port has no jit, no compile cache and no
donation; jit-purity's host-RNG ban lives on in ``prng-discipline``), and
the reference's runtime half, ``CompileSentinel`` and the tracer-leak
guard (no XLA cache, no tracer).

CLI: ``python -m repro_torch.analysis`` (see its ``--help``).
"""
from .findings import BAD_SUPPRESSION, Finding, Suppression
from .linter import Linter, LintReport, run_lint
from .rules import ALL_RULES
from .walker import Project

__all__ = [
    "ALL_RULES",
    "BAD_SUPPRESSION",
    "Finding",
    "LintReport",
    "Linter",
    "Project",
    "Suppression",
    "run_lint",
]
