"""kernel-contract: kernel invocation invariants, the port's counterpart
of the reference's ``pallas-contract``.

Three checks, each tied to a promise ``kernels/ops.py`` makes:

* **a plain version behind every wrapper** — every public function of
  ``<package>.kernels.ops`` that reaches a kernel module's ``launch*``
  (through its calls and the functions it hands on, not through another
  such wrapper) has a plain version
  ``<package>.kernels.ref.<name>_ref``, and its CPU branch (an ``if``
  whose test names ``"cpu"``) calls it: the CPU tests hold that plain
  version to the JAX package, and ``chip_smoke.py`` holds the kernel to it;
* **no silent fallback** — no ``try`` whose body reaches a ``launch*`` or
  the build (``_build.build``/``entry``), through its calls or the
  functions they hand on, may have a handler that reaches
  ``kernels.ref`` or returns normally: a kernel that fails to build or
  launch raises. No ``torch.cuda.is_available()`` test may choose a device
  or the plain version; an ``if`` on it one of whose branches raises or
  exits is allowed (a tool that needs the card says so and stops);
* **exact device arithmetic** — ``_build.py``'s ``nvcc`` flag list holds
  ``--fmad=false`` (the bitwise kernels round every product, as the plain
  versions do) and no flag anywhere in the kernels package asks for fast
  math.
"""
from __future__ import annotations

import ast

from ..findings import Finding
from ..walker import FunctionInfo, Project
from .base import body_walk, symbol

RULE = "kernel-contract"

_FAST_MATH = {"--use_fast_math", "-use_fast_math", "--fmad=true", "-fmad=true"}
_EXIT_CALLS = {"sys.exit", "exit", "quit", "os._exit"}


def _reaching(
    project: Project, targets: set[FunctionInfo], barrier: set[FunctionInfo] = frozenset()
) -> set[FunctionInfo]:
    """Functions that reach ``targets`` through resolved calls or through
    functions they hand on as arguments, never through a ``barrier``
    function (it may reach them itself)."""
    edges: dict[FunctionInfo, set[FunctionInfo]] = {}
    for fn, sites in project.calls_by_function().items():
        out = edges.setdefault(fn, set())
        for site in sites:
            for expr in [site.node.func, *site.node.args]:
                callee = project.resolve_function(expr, site.module, fn)
                if callee is not None:
                    out.add(callee)
    reach = set(targets)
    changed = True
    while changed:
        changed = False
        for fn, outs in edges.items():
            if fn not in reach and (outs & reach) - barrier:
                reach.add(fn)
                changed = True
    return reach


def _calls_in(nodes, project: Project, module: str, enclosing):
    for stmt in nodes:
        for node in ast.walk(stmt):
            if isinstance(node, ast.Call):
                yield node, project.resolve_function(node.func, module, enclosing)


def _ends_in_raise(body: list[ast.stmt], project: Project, module: str) -> bool:
    if not body:
        return False
    last = body[-1]
    if isinstance(last, ast.Raise):
        return True
    if isinstance(last, ast.Expr) and isinstance(last.value, ast.Call):
        return (project.dotted(last.value.func, module) or "") in _EXIT_CALLS
    return False


def _wrappers(project: Project, findings: list[Finding]):
    ops_mod = f"{project.package}.kernels.ops"
    ref_mod = f"{project.package}.kernels.ref"
    ops = project.modules.get(ops_mod)
    if ops is None:
        return
    public = {
        fn for q, fn in ops.scan.functions.items()
        if "." not in q and not q.startswith("_")
    }
    # a wrapper reaches a launch itself, not through another wrapper
    reach = _reaching(project, set(project.launches), barrier=public)
    ref = project.modules.get(ref_mod)
    ref_names: set[str] = set()
    if ref is not None:
        ref_names = set(ref.scan.functions)
        for stmt in ref.tree.body:
            if isinstance(stmt, ast.Assign):
                ref_names |= {t.id for t in stmt.targets if isinstance(t, ast.Name)}
    for qual, fn in sorted(ops.scan.functions.items()):
        if fn not in public or fn not in reach:
            continue
        plain = f"{qual}_ref"
        if plain not in ref_names:
            findings.append(Finding(
                rule=RULE, path=fn.path, line=fn.node.lineno, symbol=qual,
                message=f"kernel wrapper `{qual}` has no plain version "
                f"`kernels.ref.{plain}`: the CPU tests and the card's "
                "check have nothing to hold the kernel to",
            ))
            continue
        cpu_calls = False
        for node in body_walk(fn):
            if not isinstance(node, ast.If) or not any(
                isinstance(c, ast.Constant) and c.value == "cpu"
                for c in ast.walk(node.test)
            ):
                continue
            for call, _ in _calls_in(node.body, project, ops_mod, fn):
                if project.dotted(call.func, ops_mod) == f"{ref_mod}.{plain}":
                    cpu_calls = True
        if not cpu_calls:
            findings.append(Finding(
                rule=RULE, path=fn.path, line=fn.node.lineno, symbol=qual,
                message=f"kernel wrapper `{qual}` has no CPU branch that "
                f"calls its plain version `kernels.ref.{plain}`",
            ))


def _fallbacks(project: Project, findings: list[Finding], reach: set[FunctionInfo]):
    ref_mod = f"{project.package}.kernels.ref"
    for mod in project.modules.values():
        owners: dict[int, FunctionInfo | None] = {}
        for fn in mod.scan.functions.values():
            for node in body_walk(fn):
                owners[id(node)] = fn
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Try):
                continue
            fn = owners.get(id(node))
            # a call reaches a launch itself or through a function it hands
            # on (``KernelFunction.apply(_launch_x, ...)``), as in _reaching
            if not any(
                project.resolve_function(expr, mod.name, fn) in reach
                for call, _ in _calls_in(node.body, project, mod.name, fn)
                for expr in [call.func, *call.args]
            ):
                continue
            for handler in node.handlers:
                to_ref = any(
                    (project.dotted(call.func, mod.name) or "").startswith(ref_mod + ".")
                    or (callee is not None and callee.module == ref_mod)
                    for call, callee in _calls_in(handler.body, project, mod.name, fn)
                )
                if to_ref or not _ends_in_raise(handler.body, project, mod.name):
                    findings.append(Finding(
                        rule=RULE, path=mod.path, line=handler.lineno,
                        symbol=fn.qualname if fn else "<module>",
                        message="a handler around a kernel build or launch "
                        + ("falls back to the plain version" if to_ref
                           else "returns normally")
                        + ": a kernel that fails to build or launch must raise",
                    ))


def _is_available_tests(project: Project, findings: list[Finding]):
    for mod in project.modules.values():
        allowed: set[int] = set()
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.If) and (
                _ends_in_raise(node.body, project, mod.name)
                or _ends_in_raise(node.orelse, project, mod.name)
            ):
                allowed |= {id(c) for c in ast.walk(node.test)}
        for site in mod.scan.calls:
            if project.dotted(site.node.func, mod.name) != "torch.cuda.is_available":
                continue
            if id(site.node) in allowed:
                continue
            findings.append(Finding(
                rule=RULE, path=site.path, line=site.node.lineno,
                symbol=symbol(site),
                message="`torch.cuda.is_available()` chooses a device or a "
                "plain version: take an explicit device, and where the card "
                "is needed raise or exit without one",
            ))


def _flags(project: Project, findings: list[Finding]):
    build_mod = f"{project.package}.kernels._build"
    build = project.modules.get(build_mod)
    if build is not None:
        flag_lists = [
            stmt for stmt in build.tree.body
            if isinstance(stmt, ast.Assign)
            and any(isinstance(t, ast.Name) and t.id.endswith("FLAGS")
                    for t in stmt.targets)
            and isinstance(stmt.value, (ast.Tuple, ast.List))
        ]
        if not flag_lists:
            findings.append(Finding(
                rule=RULE, path=build.path, line=1,
                message="no nvcc flag list (`*FLAGS = (...)`) in _build.py",
            ))
        for stmt in flag_lists:
            flags = {
                e.value for e in stmt.value.elts
                if isinstance(e, ast.Constant) and isinstance(e.value, str)
            }
            if "--fmad=false" not in flags:
                findings.append(Finding(
                    rule=RULE, path=build.path, line=stmt.lineno,
                    message="the nvcc flags lack --fmad=false: products fused "
                    "into FMAs round differently from the plain versions",
                ))
    prefix = f"{project.package}.kernels"
    for mod in project.modules.values():
        if mod.name != prefix and not mod.name.startswith(prefix + "."):
            continue
        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Constant) and node.value in _FAST_MATH:
                findings.append(Finding(
                    rule=RULE, path=mod.path, line=node.lineno,
                    message=f"`{node.value}` asks nvcc for inexact device "
                    "arithmetic: every library builds with --fmad=false",
                ))


def check(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    _wrappers(project, findings)
    build_mod = project.modules.get(f"{project.package}.kernels._build")
    build_fns = set()
    if build_mod is not None:
        build_fns = {
            fn for q, fn in build_mod.scan.functions.items() if q in ("build", "entry")
        }
    _fallbacks(project, findings, _reaching(project, set(project.launches) | build_fns))
    _is_available_tests(project, findings)
    _flags(project, findings)
    return findings
