"""The PyTorch port stands alone: no module of ``src/repro_torch`` and no
line of ``chip_smoke.py`` imports ``jax`` or the JAX package ``repro``."""
import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield node.lineno, alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.lineno, node.module.split(".")[0]


def test_port_files_exist():
    csrc = sorted((ROOT / "src" / "repro_torch" / "csrc").glob("*.cu"))
    names = {p.relative_to(ROOT).as_posix() for p in PORT_FILES + csrc}
    for want in (
        "src/repro_torch/core/prng.py", "src/repro_torch/core/mc.py",
        "src/repro_torch/core/selection.py", "src/repro_torch/serving/router.py",
        "src/repro_torch/kernels/ops.py", "src/repro_torch/convert.py", "chip_smoke.py",
        "src/repro_torch/models/model.py", "src/repro_torch/models/blocks.py",
        "src/repro_torch/configs/__init__.py", "src/repro_torch/kernels/flash_attention.py",
        "src/repro_torch/kernels/rglru_scan.py", "src/repro_torch/kernels/mamba_scan.py",
        "src/repro_torch/kernels/mc_correctness.py", "src/repro_torch/csrc/mc_correctness.cu",
        "src/repro_torch/core/cascade.py", "src/repro_torch/core/belief.py",
        "src/repro_torch/budget_sweep.py",
    ):
        assert want in names


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: p.relative_to(ROOT).as_posix())
def test_no_jax_or_repro_import(path):
    bad = [(line, mod) for line, mod in _imported_roots(path) if mod in FORBIDDEN]
    assert not bad, f"{path}: imports {bad}"


def test_scanner_catches_forbidden_imports(tmp_path):
    probe = tmp_path / "probe.py"
    probe.write_text("import jax.numpy as jnp\nfrom repro.core import mc\nimport repro_torch\n")
    assert [m for _, m in _imported_roots(probe) if m in FORBIDDEN] == ["jax", "repro"]
