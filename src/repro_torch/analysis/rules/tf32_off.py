"""tf32-off: no code of the package turns TF32 on.

The port's f32 results are compared with the CPU's and the JAX package's
at f32 tolerances, and the MoE router picks its experts from f32 logits
(``models/moe.py``): a TF32 matmul rounds its inputs to 10 mantissa bits,
which moves those logits by far more than the near-ties the expert choice
resolves and parts the card from the CPU on every f32 check. PyTorch
leaves TF32 off for matmuls by default; this rule keeps any code of the
package from turning it on — for matmuls or for cuDNN — anywhere:

* no truthy assignment to ``torch.backends.cuda.matmul.allow_tf32`` or
  ``torch.backends.cudnn.allow_tf32`` (``False`` and ``0`` are fine);
* no ``fp32_precision = "tf32"`` under ``torch.backends``;
* no ``torch.set_float32_matmul_precision`` other than ``"highest"``;
* no ``torch.backends.cudnn.flags(allow_tf32=<truthy>)``.
"""
from __future__ import annotations

import ast

from ..findings import Finding
from ..walker import Project
from .base import body_walk, keyword, symbol

RULE = "tf32-off"

_FLAGS = {
    "torch.backends.cuda.matmul.allow_tf32",
    "torch.backends.cudnn.allow_tf32",
}


def _falsy(node: ast.expr) -> bool:
    return isinstance(node, ast.Constant) and not node.value


def check(project: Project) -> list[Finding]:
    findings: list[Finding] = []
    for mod in project.modules.values():
        owner = {
            id(node): fn.qualname
            for fn in mod.scan.functions.values() for node in body_walk(fn)
        }
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                targets = node.targets if isinstance(node, ast.Assign) else [node.target]
                for tgt in targets:
                    name = project.dotted(tgt, mod.name) or ""
                    bad = (name in _FLAGS and not (
                        isinstance(node, ast.Assign) and _falsy(node.value))) or (
                        name.startswith("torch.backends.")
                        and name.endswith(".fp32_precision")
                        and isinstance(node.value, ast.Constant)
                        and node.value.value == "tf32"
                    )
                    if bad:
                        findings.append(Finding(
                            rule=RULE, path=mod.path, line=node.lineno,
                            symbol=owner.get(id(node), "<module>"),
                            message=f"`{name}` turns TF32 on: f32 matmuls "
                            "round their inputs to 10 mantissa bits",
                        ))
        for site in mod.scan.calls:
            name = project.dotted(site.node.func, mod.name)
            if name == "torch.set_float32_matmul_precision":
                arg = site.node.args[0] if site.node.args else keyword(site.node, "precision")
                if not (isinstance(arg, ast.Constant) and arg.value == "highest"):
                    findings.append(Finding(
                        rule=RULE, path=site.path, line=site.node.lineno,
                        symbol=symbol(site),
                        message="`torch.set_float32_matmul_precision` other "
                        "than \"highest\" lets f32 matmuls run in TF32",
                    ))
            elif name == "torch.backends.cudnn.flags":
                arg = keyword(site.node, "allow_tf32")
                if arg is not None and not _falsy(arg):
                    findings.append(Finding(
                        rule=RULE, path=site.path, line=site.node.lineno,
                        symbol=symbol(site),
                        message="`torch.backends.cudnn.flags(allow_tf32=...)` "
                        "turns TF32 on for convolutions",
                    ))
    return findings
