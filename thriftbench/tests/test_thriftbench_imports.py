"""Nothing the benchmark runs imports JAX or the JAX package ``repro``, and
the reference imports nothing of the program ``repro_torch``: top-level
module names compared whole (``repro_torch`` begins with ``repro``)."""
import ast
import json
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
BENCH = REPO / "thriftbench"
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")), ids=lambda p: str(p.relative_to(REPO)))
def test_no_module_imports_jax_or_the_jax_package(path):
    assert not top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").rglob("*.py")),
                         ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert "repro_torch" not in names and not names & FORBIDDEN
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("thriftbench"):
            assert node.module.split(".")[1] in ("reference", "weights", "traffic")


@pytest.mark.parametrize("path", sorted((BENCH / "blocks").glob("*.py")), ids=lambda p: p.name)
def test_block_files_import_nothing_of_the_program(path):
    """A block file's ``forward`` is part of the plain reference."""
    names = top_level_imports(path)
    assert "repro_torch" not in names and not names & FORBIDDEN
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("thriftbench"):
            assert node.module.split(".")[1] in ("reference", "weights", "blocks", "metrics")


def test_the_whole_reference_loads_without_the_program():
    code = ("import sys; sys.path.insert(0, %r); import thriftbench.reference.check, "
            "thriftbench.reference.model, thriftbench.reference.router; "
            "print(sorted({m.split('.')[0] for m in sys.modules}))" % str(REPO))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env={"PATH": "/usr/bin:/bin", "PYTHONPATH": ""})
    assert out.returncode == 0, out.stderr
    loaded = set(json.loads(out.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert "repro_torch" not in loaded and not loaded & FORBIDDEN


def test_a_cpu_rehearsal_loads_no_jax(tmp_path):
    """The harness's whole run, the check included, on the CPU at a tiny size
    in a fresh process: nothing of JAX or the JAX package in ``sys.modules``."""
    code = f"""
import sys, json, time
sys.path[:0] = [{str(REPO)!r}, {str(REPO / 'src')!r}]
import torch
torch.set_num_threads(1)
from thriftbench.tests import tiny
from thriftbench.harness import run
from pathlib import Path
root = tiny.checkout(Path({str(tmp_path)!r}))
res = run(root, "tiny.backlog", 12345, 1.0, False, "cpu", time.monotonic(), lambda m: None)
print(json.dumps({{"correct": res["correct"], "checks": res["checks"],
                  "loaded": sorted({{m.split('.')[0] for m in sys.modules}})}}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert "repro_torch" in res["loaded"] and not set(res["loaded"]) & FORBIDDEN
