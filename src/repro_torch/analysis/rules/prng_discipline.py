"""prng-discipline: every port key is sampled at most once, and no code
of the package draws from a global RNG.

The CRN (common-random-numbers) contract that makes batched plans bitwise
equal to serial plans — and the port's draws bitwise the reference's —
hinges on key flow through :mod:`repro_torch.core.prng`, the torch
emulation of jax's threefry: ``key`` constructs a key, ``split`` and
``fold_in`` *derive* keys any number of times (that is how ``_draw_rows``
gets its prefix-stable per-row streams), and ``random_bits``, ``uniform``
and ``randint`` *sample*, at most once per key. Two samplers fed the same
key return correlated draws; a key that is both sampled and split seeds
two streams that silently share bits. Both bugs pass every shape check
and corrupt xi estimates only statistically, which is why they get a
static rule instead of a test.

The torch form of the reference's host-RNG ban (its ``jit-purity``) is
part of this rule, anywhere in the package: no ``torch.manual_seed`` /
``torch.seed``, no ``torch.rand*``/``randn``/``randint``/``randperm``/
``normal``/``bernoulli``/``multinomial`` and no in-place sampler
(``.normal_()``, ``.uniform_()``, ...) without ``generator=``, and no
module-level sampler of ``numpy.random`` or of ``random``. Every random
bit comes from a port key or from an explicit generator
(``torch.Generator(...).manual_seed(s)``, ``np.random.default_rng(s)``).
"""
from __future__ import annotations

import ast

from ..findings import Finding
from ..walker import FunctionInfo, Project
from .base import keyword, param_names, symbol

RULE = "prng-discipline"

_CONSTRUCTORS = {"key"}
_DERIVERS = {"split", "fold_in"}
_SAMPLERS = {"random_bits", "uniform", "randint"}

_TORCH_SEEDERS = {
    "torch.manual_seed", "torch.seed", "torch.random.manual_seed",
    "torch.random.seed", "torch.cuda.manual_seed", "torch.cuda.manual_seed_all",
    "torch.cuda.seed", "torch.cuda.seed_all",
}
_TORCH_SAMPLERS = {
    "rand", "rand_like", "randn", "randn_like", "randint", "randint_like",
    "randperm", "normal", "bernoulli", "multinomial", "poisson",
}
_INPLACE_SAMPLERS = {
    "normal_", "uniform_", "random_", "bernoulli_", "exponential_",
    "geometric_", "log_normal_", "cauchy_",
}
# explicit generators and their bit generators: sanctioned
_NUMPY_EXPLICIT = {
    "default_rng", "Generator", "SeedSequence", "BitGenerator", "PCG64",
    "PCG64DXSM", "Philox", "SFC64", "MT19937", "RandomState",
}
_RANDOM_EXPLICIT = {"Random"}


def _prng_member(project: Project, call: ast.Call, fn: FunctionInfo) -> str | None:
    """The name of the port PRNG function ``call`` calls, if any."""
    prng = f"{project.package}.core.prng"
    dotted = project.dotted(call.func, fn.module)
    if dotted and dotted.startswith(prng + "."):
        return dotted[len(prng) + 1:]
    if fn.module == prng and isinstance(call.func, ast.Name):
        callee = project.resolve_function(call.func, fn.module, fn)
        if callee is not None and callee.module == prng:
            return callee.name
    return None


def _key_param_names(fn: FunctionInfo) -> set[str]:
    return {
        p
        for p in param_names(fn)
        if p in ("key", "k", "keys") or p.endswith("_key")
    }


def _key_flow(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    by_fn = project.calls_by_function()
    for fn in sorted(by_fn, key=lambda f: (f.path, f.qualname)):
        key_vars = _key_param_names(fn)
        # vars assigned from key constructors / derivers are keys too
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
                if _prng_member(project, node.value, fn) in _CONSTRUCTORS | _DERIVERS:
                    for tgt in node.targets:
                        elts = (
                            tgt.elts
                            if isinstance(tgt, (ast.Tuple, ast.List))
                            else [tgt]
                        )
                        for elt in elts:
                            if isinstance(elt, ast.Name):
                                key_vars.add(elt.id)

        consumed: dict[str, list[int]] = {}
        derived: dict[str, list[int]] = {}
        for site in by_fn[fn]:
            member = _prng_member(project, site.node, fn)
            if member not in _DERIVERS | _SAMPLERS:
                continue
            # the key operand is the first positional or the `k=`/`key=` kwarg
            key_arg = site.node.args[0] if site.node.args else None
            for name in ("k", "key"):
                key_arg = keyword(site.node, name) or key_arg
            if not isinstance(key_arg, ast.Name) or key_arg.id not in key_vars:
                continue  # derived inline (fold_in(k, t) etc.) — fine
            # a consumption inside a loop happens >= twice
            weight = 2 if site.loop_depth > 0 else 1
            into = derived if member in _DERIVERS else consumed
            into.setdefault(key_arg.id, []).extend([site.node.lineno] * weight)

        for var, lines in consumed.items():
            if len(lines) >= 2:
                findings.append(
                    Finding(
                        rule=RULE,
                        path=fn.path,
                        line=lines[1] if len(set(lines)) > 1 else lines[0],
                        symbol=fn.qualname,
                        message=f"key `{var}` sampled more than once "
                        f"(lines {sorted(set(lines))}): reuse correlates "
                        "draws — fold_in/split a fresh subkey per use",
                    )
                )
            if var in derived:
                findings.append(
                    Finding(
                        rule=RULE,
                        path=fn.path,
                        line=lines[0],
                        symbol=fn.qualname,
                        message=f"key `{var}` is both sampled from and "
                        f"split/fold_in-derived (derive at line "
                        f"{derived[var][0]}): the sampler stream aliases "
                        "the derived streams",
                    )
                )
    return findings


def _global_rng(project: Project, call: ast.Call, module: str) -> str | None:
    """Why ``call`` draws from (or seeds) a global RNG, or ``None``."""
    dotted = project.dotted(call.func, module) or ""
    has_gen = keyword(call, "generator") is not None
    if dotted in _TORCH_SEEDERS:
        return "seeds torch's global RNG: draw from an explicit " \
            "torch.Generator(...).manual_seed(s)"
    if dotted.startswith("torch.") and dotted[len("torch."):] in _TORCH_SAMPLERS:
        if not has_gen:
            return "samples torch's global RNG: pass generator="
        return None
    if (
        isinstance(call.func, ast.Attribute)
        and call.func.attr in _INPLACE_SAMPLERS
        and not has_gen
    ):
        return "samples torch's global RNG in place: pass generator="
    head = call.func
    while isinstance(head, ast.Attribute):
        head = head.value
    imports = project.modules[module].scan.imports
    if not (isinstance(head, ast.Name) and head.id in imports):
        return None
    if dotted.startswith("numpy.random.") and (
        dotted.split(".")[2] not in _NUMPY_EXPLICIT
    ):
        return "numpy's global RNG: draw from np.random.default_rng(seed)"
    if dotted.startswith("random.") and dotted.split(".")[1] not in _RANDOM_EXPLICIT:
        return "the random module's global RNG: use an explicit generator"
    return None


def check(project: Project) -> list[Finding]:
    findings = _key_flow(project)
    for mod in project.modules.values():
        for site in mod.scan.calls:
            why = _global_rng(project, site.node, mod.name)
            if why is not None:
                findings.append(
                    Finding(
                        rule=RULE,
                        path=site.path,
                        line=site.node.lineno,
                        symbol=symbol(site),
                        message=f"`{project.dotted(site.node.func, mod.name)}"
                        f"(...)` {why}",
                    )
                )
    return findings
