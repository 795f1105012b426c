"""No file of the benchmark imports JAX or the JAX package, by top-level
module name compared whole (``gnn_rul_tpu_torch`` begins with
``gnn_rul_tpu`` and is neither), and the references import nothing of
the program."""

import ast
import sys

import pytest

from portbench import run
from portbench.harness.cell import BENCH_DIR

FORBIDDEN = {"jax", "jaxlib", "flax", "gnn_rul_tpu"}


def _imports(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args \
                and isinstance(node.args[0], ast.Constant):
            names.add(str(node.args[0].value).split(".")[0])
    return names


FILES = sorted(BENCH_DIR.rglob("*.py"))


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(
    p.relative_to(BENCH_DIR)))
def test_no_file_imports_jax_or_the_jax_package(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH_DIR / "reference").glob(
    "*.py")), ids=lambda p: p.name)
def test_the_references_import_nothing_of_the_program(path):
    assert not {n for n in _imports(path) if n.startswith("gnn_rul_tpu")}


def test_the_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "gnn_rul_tpu_torch_fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "gnn_rul_tpu.fake", object())
    assert run.forbidden_modules() == ["gnn_rul_tpu"]


def test_a_run_imports_no_jax(tmp_path):
    """A CPU run of a cell through the runners leaves no JAX module
    loaded (checked in a fresh interpreter)."""
    import subprocess
    code = (
        "import sys, types, time, torch\n"
        f"sys.path.insert(0, {str(BENCH_DIR.parent)!r})\n"
        "from portbench.tests.conftest import tiny_cell, run_cell\n"
        "run_cell(tiny_cell('logo_bearing-phm2012.serve'), seconds=0.2)\n"
        "from portbench.run import forbidden_modules\n"
        "print(forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
