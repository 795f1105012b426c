"""The port stands alone: no module of gnn_rul_tpu_torch, and not
chip_smoke.py, imports JAX, Flax, optax or the JAX package."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "optax", "gnn_rul_tpu"}
SOURCES = sorted((ROOT / "gnn_rul_tpu_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]


def _imported_roots(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(ROOT)))
def test_source_imports_nothing_of_jax(path):
    assert not BANNED & set(_imported_roots(path))


def test_importing_the_port_loads_no_jax():
    code = ("import sys, gnn_rul_tpu_torch.export, gnn_rul_tpu_torch.cli, "
            "gnn_rul_tpu_torch.train.trainer; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in {'jax', 'flax', 'optax', 'gnn_rul_tpu'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT)},
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"
