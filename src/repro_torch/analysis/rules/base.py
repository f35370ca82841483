"""Shared helpers for the port's thriftlint rule passes.

Each rule module exposes ``RULE`` (its id) and ``check(project) ->
list[Finding]``.  Rules never parse source themselves — they consume the
:class:`~repro_torch.analysis.walker.Project` call-graph and report
locations through :class:`~repro_torch.analysis.findings.Finding`.
"""
from __future__ import annotations

import ast
from typing import Iterator

from ..walker import CallSite, FunctionInfo, Project


def body_walk(fn: FunctionInfo) -> Iterator[ast.AST]:
    """Walk a function's own statements, *excluding* nested ``def``s —
    nested functions are separate nodes in the call graph and are
    analysed on their own (they would double-report otherwise)."""
    stack: list[ast.AST] = list(fn.node.body)
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def param_names(fn: FunctionInfo) -> set[str]:
    a = fn.node.args
    names = [p.arg for p in a.posonlyargs + a.args + a.kwonlyargs]
    if a.vararg:
        names.append(a.vararg.arg)
    if a.kwarg:
        names.append(a.kwarg.arg)
    return set(names)


def in_critical_module(project: Project, fn: FunctionInfo) -> bool:
    """Does this function live in the bit-stability-critical plane?"""
    return fn.module.startswith(tuple(project.critical_prefixes))


def keyword(call: ast.Call, name: str) -> ast.expr | None:
    """The value of keyword argument ``name`` of ``call``, if given."""
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def symbol(site: CallSite) -> str:
    return site.enclosing.qualname if site.enclosing else "<module>"
