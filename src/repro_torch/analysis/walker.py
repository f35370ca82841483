"""AST / call-graph core for the port's thriftlint.

Parses every module under ``src/repro_torch`` and finds the *device-plane
roots*: the code whose results the bitwise and kernel contracts cover.
The port has no trace, so where the JAX package's walker starts from
``jax.jit`` / ``lax`` / ``pl.pallas_call`` entry points, this one starts
from three kinds of root:

* :data:`DEVICE_ROOTS` — the port's counterparts, by module and name, of
  the JAX package's jitted entry points in ``core/`` and ``serving/``
  (the CRN sampler, the xi cores, the planner scan, the wave loop);
* every method of a ``torch.autograd.Function`` subclass (the kernel
  forwards and their plain versions' backwards);
* every function that calls a kernel module's ``launch*`` (a module of
  ``<package>.kernels`` that defines ``launch`` or ``launch_<x>``).

It computes the transitive closure of functions reachable from those
roots through ordinary calls, lexical nesting and cross-module imports.
Rules consume this: "device-reachable" in a rule means *a member of that
closure*.

The module scan, import resolution, ``dotted``/``resolve_function``, the
call sites and the closure are the JAX package's (``repro.analysis.walker``),
copied; a test holds the two walkers to the same modules, functions and
call sites. Everything here is static and name-based. Dynamic dispatch
through instance attributes or function-valued parameters
(``KernelFunction.apply(launch, ...)``) is out of scope here and
deliberately ignored rather than guessed at; ``kernel-contract`` follows
functions handed on as call arguments itself.
"""
from __future__ import annotations

import ast
from dataclasses import dataclass, field
from pathlib import Path

# (module below the package, top-level function): the port's counterparts
# of the JAX package's jit entry points in core/ and serving/
DEVICE_ROOTS = (
    ("core.mc", "sample_pool_responses"),
    ("core.mc", "sample_pool_responses_grouped"),
    ("core.mc", "xi_from_responses"),
    ("core.mc", "_masked_xi_core"),
    ("core.mc", "_marginal_xi_core"),
    ("core.mc", "_tables_xi_core"),
    ("core.selection", "_sur_greedy_scan_core"),
    ("serving.router", "_wave_scan_core"),
)

# subpackages whose device-plane reductions carry the serial == batched
# and card == CPU bit-match contracts
CRITICAL_SUBPACKAGES = ("core", "serving")

AUTOGRAD_FUNCTION_NAMES = {
    "torch.autograd.Function",
    "torch.autograd.function.Function",
}
PARTIAL_NAMES = {"functools.partial", "partial"}
# kernel modules live here, below the package; these are not kernel modules
KERNELS_SUBPACKAGE = "kernels"
NOT_KERNEL_MODULES = {"ops", "ref"}


def is_launch_name(name: str) -> bool:
    """``launch`` or ``launch_<x>``: a kernel module's entry points."""
    return name == "launch" or name.startswith("launch_")


@dataclass
class FunctionInfo:
    """One ``def`` (top-level, method, or nested) in the scanned tree."""

    module: str
    path: str
    qualname: str
    node: ast.FunctionDef
    parent: "FunctionInfo | None" = None
    class_name: str = ""
    children: dict[str, "FunctionInfo"] = field(default_factory=dict)

    @property
    def name(self) -> str:
        return self.node.name

    @property
    def key(self) -> tuple[str, str]:
        return (self.path, self.qualname)

    def __hash__(self):
        return hash(self.key)

    def __eq__(self, other):
        return isinstance(other, FunctionInfo) and self.key == other.key


@dataclass
class ClassInfo:
    """One ``class`` and the ``def``s directly in its body."""

    name: str
    node: ast.ClassDef
    methods: list[FunctionInfo] = field(default_factory=list)


@dataclass
class CallSite:
    """A ``Call`` node plus where it syntactically lives."""

    node: ast.Call
    module: str
    path: str
    enclosing: FunctionInfo | None   # innermost def, None at module scope
    loop_depth: int                  # For/While ancestors inside `enclosing`


class _ModuleScanner(ast.NodeVisitor):
    """Single pass over one module: functions, classes, imports, calls."""

    def __init__(self, module: str, path: str):
        self.module = module
        self.path = path
        self.imports: dict[str, str] = {}
        self.functions: dict[str, FunctionInfo] = {}
        self.classes: list[ClassInfo] = []
        self.calls: list[CallSite] = []
        self._fn_stack: list[FunctionInfo] = []
        self._class_stack: list[str] = []
        self._owner: list[FunctionInfo | ClassInfo] = []
        self._loop_depth = 0

    # -- imports ----------------------------------------------------------
    def visit_Import(self, node: ast.Import):
        for alias in node.names:
            self.imports[alias.asname or alias.name.split(".")[0]] = (
                alias.name if alias.asname else alias.name.split(".")[0]
            )
            if alias.asname:
                self.imports[alias.asname] = alias.name

    def visit_ImportFrom(self, node: ast.ImportFrom):
        if node.level:
            parts = self.module.split(".")
            base = ".".join(parts[: len(parts) - node.level])
        else:
            base = ""
        mod = ".".join(p for p in (base, node.module or "") if p)
        for alias in node.names:
            target = f"{mod}.{alias.name}" if mod else alias.name
            self.imports[alias.asname or alias.name] = target

    # -- definitions ------------------------------------------------------
    def _visit_def(self, node):
        prefix = ""
        if self._fn_stack:
            prefix = self._fn_stack[-1].qualname + ".<locals>."
        elif self._class_stack:
            prefix = ".".join(self._class_stack) + "."
        info = FunctionInfo(
            module=self.module,
            path=self.path,
            qualname=prefix + node.name,
            node=node,
            parent=self._fn_stack[-1] if self._fn_stack else None,
            class_name=self._class_stack[-1] if self._class_stack else "",
        )
        self.functions[info.qualname] = info
        if info.parent is not None:
            info.parent.children[node.name] = info
        if self._owner and isinstance(self._owner[-1], ClassInfo):
            self._owner[-1].methods.append(info)
        for dec in node.decorator_list:
            self.visit(dec)
        self._fn_stack.append(info)
        self._owner.append(info)
        outer_loops, self._loop_depth = self._loop_depth, 0
        for stmt in node.body:
            self.visit(stmt)
        self._loop_depth = outer_loops
        self._owner.pop()
        self._fn_stack.pop()

    visit_FunctionDef = _visit_def
    visit_AsyncFunctionDef = _visit_def

    def visit_ClassDef(self, node: ast.ClassDef):
        cls = ClassInfo(node.name, node)
        self.classes.append(cls)
        self._class_stack.append(node.name)
        self._owner.append(cls)
        self.generic_visit(node)
        self._owner.pop()
        self._class_stack.pop()

    # -- calls ------------------------------------------------------------
    def visit_Call(self, node: ast.Call):
        self.calls.append(
            CallSite(
                node=node,
                module=self.module,
                path=self.path,
                enclosing=self._fn_stack[-1] if self._fn_stack else None,
                loop_depth=self._loop_depth,
            )
        )
        self.generic_visit(node)

    def _visit_loop(self, node):
        self._loop_depth += 1
        self.generic_visit(node)
        self._loop_depth -= 1

    visit_For = _visit_loop
    visit_While = _visit_loop


@dataclass
class ModuleInfo:
    name: str
    path: str
    text: str
    tree: ast.Module
    scan: _ModuleScanner


class Project:
    """All parsed modules plus the device-plane reachability closure."""

    def __init__(self, src_root: Path, package: str = "repro_torch"):
        self.src_root = Path(src_root)
        self.package = package
        self.critical_prefixes = tuple(f"{package}.{s}" for s in CRITICAL_SUBPACKAGES)
        self.modules: dict[str, ModuleInfo] = {}
        self.device_roots: list[FunctionInfo] = []
        self.stale_roots: list[tuple[str, str]] = []
        self.autograd_methods: list[FunctionInfo] = []
        self.launches: set[FunctionInfo] = set()
        self.launch_sites: list[CallSite] = []
        self.reachable: set[FunctionInfo] = set()
        self._load()
        self._find_roots()
        self._close_reachability()

    # -- loading ----------------------------------------------------------
    def _load(self):
        pkg_dir = self.src_root / self.package
        for path in sorted(pkg_dir.rglob("*.py")):
            rel = path.relative_to(self.src_root)
            mod = ".".join(rel.with_suffix("").parts)
            if mod.endswith(".__init__"):
                mod = mod[: -len(".__init__")]
            text = path.read_text()
            tree = ast.parse(text, filename=str(path))
            scan = _ModuleScanner(mod, str(rel.as_posix()))
            scan.visit(tree)
            self.modules[mod] = ModuleInfo(
                name=mod, path=str(rel.as_posix()), text=text, tree=tree,
                scan=scan,
            )

    # -- name resolution --------------------------------------------------
    def dotted(self, expr: ast.expr, module: str) -> str | None:
        """Expand an attribute chain to a fully qualified dotted name,
        resolving the leading alias through the module's imports
        (``np.sum`` -> ``numpy.sum``)."""
        parts: list[str] = []
        node = expr
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        info = self.modules.get(module)
        head = node.id
        if info is not None and head in info.scan.imports:
            head = info.scan.imports[head]
        parts.append(head)
        return ".".join(reversed(parts))

    def resolve_function(
        self,
        expr: ast.expr,
        module: str,
        enclosing: FunctionInfo | None,
    ) -> FunctionInfo | None:
        """Resolve a function-valued expression to a FunctionInfo, looking
        through lexical scope, the module, sibling package modules, and
        ``functools.partial`` wrapping."""
        if isinstance(expr, ast.Call):  # partial(fn, ...)
            fq = self.dotted(expr.func, module)
            if fq in PARTIAL_NAMES and expr.args:
                return self.resolve_function(expr.args[0], module, enclosing)
            return None
        info = self.modules.get(module)
        if info is None:
            return None
        if isinstance(expr, ast.Name):
            cur = enclosing
            while cur is not None:
                if expr.id in cur.children:
                    return cur.children[expr.id]
                cur = cur.parent
            if expr.id in info.scan.functions:
                return info.scan.functions[expr.id]
            target = info.scan.imports.get(expr.id)
            if target:
                return self._lookup_qualified(target)
            return None
        if isinstance(expr, ast.Attribute):
            # self.method() within a class
            if (
                isinstance(expr.value, ast.Name)
                and expr.value.id in ("self", "cls")
                and enclosing is not None
                and enclosing.class_name
            ):
                qual = f"{enclosing.class_name}.{expr.attr}"
                return info.scan.functions.get(qual)
            fq = self.dotted(expr, module)
            if fq:
                return self._lookup_qualified(fq)
        return None

    def _lookup_qualified(self, fq: str) -> FunctionInfo | None:
        """``repro_torch.core.mc.bucket_size`` -> its FunctionInfo, if ours."""
        if not fq.startswith(self.package + ".") and fq != self.package:
            return None
        parts = fq.split(".")
        for split in range(len(parts), 0, -1):
            mod = ".".join(parts[:split])
            if mod in self.modules:
                rest = ".".join(parts[split:])
                if not rest:
                    return None
                return self.modules[mod].scan.functions.get(rest)
        return None

    # -- device-plane roots -----------------------------------------------
    def kernel_module(self, module: str) -> bool:
        """A module of ``<package>.kernels`` that defines a ``launch*``."""
        prefix = f"{self.package}.{KERNELS_SUBPACKAGE}."
        if not module.startswith(prefix):
            return False
        leaf = module[len(prefix):]
        if "." in leaf or leaf.startswith("_") or leaf in NOT_KERNEL_MODULES:
            return False
        return any(
            is_launch_name(q) for q in self.modules[module].scan.functions
        )

    def _find_roots(self):
        roots: set[FunctionInfo] = set()
        # (a) the named counterparts of the reference's jit entry points
        for mod, name in DEVICE_ROOTS:
            fn = self._lookup_qualified(f"{self.package}.{mod}.{name}")
            if fn is None:
                self.stale_roots.append((mod, name))
            else:
                self.device_roots.append(fn)
                roots.add(fn)
        for mod in self.modules.values():
            # (b) every method of a torch.autograd.Function subclass
            for cls in mod.scan.classes:
                if any(
                    self.dotted(base, mod.name) in AUTOGRAD_FUNCTION_NAMES
                    for base in cls.node.bases
                ):
                    self.autograd_methods.extend(cls.methods)
                    roots.update(cls.methods)
            if self.kernel_module(mod.name):
                self.launches.update(
                    fn for q, fn in mod.scan.functions.items()
                    if is_launch_name(q)
                )
        # (c) every function that calls a kernel module's launch*
        for mod in self.modules.values():
            for site in mod.scan.calls:
                callee = self.resolve_function(
                    site.node.func, mod.name, site.enclosing
                )
                if callee in self.launches:
                    self.launch_sites.append(site)
                    if site.enclosing is not None:
                        roots.add(site.enclosing)
        self._roots = roots

    def _close_reachability(self):
        work = list(self._roots)
        seen: set[FunctionInfo] = set(work)
        by_fn = self.calls_by_function()
        while work:
            fn = work.pop()
            self.reachable.add(fn)
            nxt: list[FunctionInfo] = list(fn.children.values())
            for site in by_fn.get(fn, ()):
                callee = self.resolve_function(
                    site.node.func, site.module, fn
                )
                if callee is not None:
                    nxt.append(callee)
            for callee in nxt:
                if callee not in seen:
                    seen.add(callee)
                    work.append(callee)

    # -- conveniences for rules -------------------------------------------
    def calls_by_function(self) -> dict[FunctionInfo, list[CallSite]]:
        """Call sites indexed by their innermost enclosing function."""
        out: dict[FunctionInfo, list[CallSite]] = {}
        for mod in self.modules.values():
            for site in mod.scan.calls:
                if site.enclosing is not None:
                    out.setdefault(site.enclosing, []).append(site)
        return out

    def iter_reachable(self):
        return sorted(self.reachable, key=lambda f: (f.path, f.qualname))

    def iter_functions(self):
        for mod in self.modules.values():
            yield from mod.scan.functions.values()
