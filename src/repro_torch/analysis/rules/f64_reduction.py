"""f64-reduction: determinism-critical reductions must be explicit.

The port's serial == batched and card == CPU bit-match contracts (the
planner's marginal gains and candidate scores, the wave loop's vote
prefixes, the xi cores) hold because every accumulation on that plane is
either (a) an explicit float64 sum (``dtype=torch.float64``, or an operand
cast ``.to(torch.float64)`` / ``.double()``) or (b) exact (integer-valued
counts, boolean indicators). An unannotated ``torch.sum``/``einsum`` or
``.sum()`` in a device-reachable function of ``repro_torch.core`` /
``repro_torch.serving`` inherits its input's dtype and the backend's
reduction order, and the CPU's and the card's orders differ — which is
exactly how the card and the CPU part in the last bit.

Exact-by-construction operands (comparisons, integer or bool casts) are
skipped; anything else must name its accumulator dtype, cast its operands
to float64, or carry an inline suppression explaining why float32 is
intended.

Also flagged: accumulation driven by *set* iteration — Python set order
is hash-seed-dependent, so a ``for x in {...}: acc += ...`` loop computes
a different floating-point sum per process.
"""
from __future__ import annotations

import ast

from ..findings import Finding
from ..walker import Project
from .base import body_walk, in_critical_module, keyword

RULE = "f64-reduction"

# torch.<name>(...) reducers, and reducers in method form x.<name>(...)
_REDUCERS = {
    "sum", "mean", "prod", "cumsum", "einsum", "matmul", "tensordot",
    "dot", "vdot", "inner", "nansum", "nanmean", "mm", "bmm", "mv",
}
_METHOD_REDUCERS = {"sum", "mean", "prod", "cumsum"}
_EXACT_DTYPES = ("int", "bool", "long", "short", "uint8")
_F64_DTYPES = ("torch.float64", "torch.double")
_EXACT_METHODS = {"int", "long", "bool", "short", "byte", "char"}
_CAST_METHODS = {"to", "type"}


def _reducer(project: Project, call: ast.Call, module: str):
    """``(name, operands)`` if ``call`` is a reducer, else ``None``."""
    dotted = project.dotted(call.func, module)
    if dotted is not None and dotted.startswith("torch."):
        name = dotted[len("torch."):]
        if name in _REDUCERS:
            operands = [
                a for a in call.args
                if not (isinstance(a, ast.Constant) and isinstance(a.value, str))
            ]  # an einsum's subscript spec is no operand
            return name, operands
        return None
    if (
        isinstance(call.func, ast.Attribute)
        and call.func.attr in _METHOD_REDUCERS
    ):
        return call.func.attr, [call.func.value]
    return None


def _cast_dtype(project: Project, node: ast.expr, module: str) -> str:
    """The dtype a ``x.to(d)`` / ``x.type(d)`` / ``torch.as_tensor(x,
    dtype=d)`` call names, dotted, or ``""``."""
    if not isinstance(node, ast.Call):
        return ""
    target = keyword(node, "dtype")
    if (
        target is None
        and isinstance(node.func, ast.Attribute)
        and node.func.attr in _CAST_METHODS
        and node.args
    ):
        target = node.args[0]
    if target is None:
        return ""
    return project.dotted(target, module) or ""


def _is_f64(project: Project, node: ast.expr, module: str) -> bool:
    """A float64 operand: a cast to float64, or arithmetic with one (torch
    promotes the other float operand)."""
    if isinstance(node, ast.BinOp) and isinstance(
        node.op, (ast.Add, ast.Sub, ast.Mult, ast.Div)
    ):
        return _is_f64(project, node.left, module) or _is_f64(
            project, node.right, module
        )
    if (
        isinstance(node, ast.Call)
        and isinstance(node.func, ast.Attribute)
        and node.func.attr == "double"
    ):
        return True
    return _cast_dtype(project, node, module) in _F64_DTYPES


def _is_exact(project: Project, node: ast.expr, module: str) -> bool:
    """Operand is exactly representable: a comparison, an integer or bool
    cast, an integer constant, or a product / mask of such."""
    if isinstance(node, ast.Compare):
        return True
    if isinstance(node, ast.Constant):
        return isinstance(node.value, (bool, int))
    if isinstance(node, ast.UnaryOp) and isinstance(node.op, (ast.Invert, ast.Not)):
        return _is_exact(project, node.operand, module)
    if isinstance(node, ast.BinOp) and isinstance(
        node.op, (ast.Mult, ast.BitAnd, ast.BitOr)
    ):
        return _is_exact(project, node.left, module) and _is_exact(
            project, node.right, module
        )
    if isinstance(node, ast.Call):
        if isinstance(node.func, ast.Attribute) and node.func.attr in _EXACT_METHODS:
            return True
        dtype = _cast_dtype(project, node, module)
        if dtype.startswith("torch.") and any(t in dtype for t in _EXACT_DTYPES):
            return True
        dotted = project.dotted(node.func, module) or ""
        if dotted == "torch.where" and len(node.args) == 3:
            return all(_is_exact(project, a, module) for a in node.args[1:])
    return False


def _explicit(project: Project, node: ast.expr, module: str) -> bool:
    return _is_f64(project, node, module) or _is_exact(project, node, module)


def check(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    for fn in project.iter_reachable():
        if not in_critical_module(project, fn):
            continue
        for node in body_walk(fn):
            if isinstance(node, (ast.Call, ast.BinOp)):
                if isinstance(node, ast.BinOp):
                    if not isinstance(node.op, ast.MatMult):
                        continue
                    red, operands = "@", [node.left, node.right]
                else:
                    found = _reducer(project, node, fn.module)
                    if found is None:
                        continue
                    red, operands = found
                    if keyword(node, "dtype") is not None:
                        continue
                if operands and all(
                    _explicit(project, a, fn.module) for a in operands
                ):
                    continue
                findings.append(
                    Finding(
                        rule=RULE,
                        path=fn.path,
                        line=node.lineno,
                        symbol=fn.qualname,
                        message=f"`{red}` without explicit accumulator "
                        "dtype on the bit-stability-critical plane: pass "
                        "dtype=torch.float64 or cast the operands "
                        "(or suppress with the reason float32 is exact "
                        "here)",
                    )
                )
            elif isinstance(node, ast.For):
                it = node.iter
                is_set = isinstance(it, ast.Set) or (
                    isinstance(it, ast.Call)
                    and (project.dotted(it.func, fn.module) or "")
                    in ("set", "frozenset")
                )
                if is_set and any(
                    isinstance(child, ast.AugAssign)
                    for stmt in node.body
                    for child in ast.walk(stmt)
                ):
                    findings.append(
                        Finding(
                            rule=RULE,
                            path=fn.path,
                            line=node.lineno,
                            symbol=fn.qualname,
                            message="accumulation over set iteration: "
                            "set order is hash-seed-dependent, so the "
                            "float sum differs across processes — "
                            "iterate a sorted sequence",
                        )
                    )
    return findings
