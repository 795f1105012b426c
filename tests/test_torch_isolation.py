"""The port stands alone: no module of gnn_rul_tpu_torch, and not
chip_smoke.py, imports JAX, Flax, optax, the JAX package or pandas (the
card's machine has no pandas), and its preprocessors run where pandas
cannot be imported."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

from gnn_rul_tpu.data import xjtu_sy
from test_data_bearing import phm_tree, xjtu_tree  # noqa: F401 (fixtures)
from test_data_cmapss import _write_raw

ROOT = Path(__file__).resolve().parents[1]
BANNED = {"jax", "jaxlib", "flax", "optax", "gnn_rul_tpu", "pandas"}
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
            "gnn_rul_tpu_torch.train.trainer, gnn_rul_tpu_torch.utils, "
            "gnn_rul_tpu_torch.parallel.graph_partition, "
            "gnn_rul_tpu_torch.parallel.dp, "
            "gnn_rul_tpu_torch.parallel.model_axis, "
            "gnn_rul_tpu_torch.parallel._dist_worker; "
            "print(sorted(m for m in sys.modules "
            "if m.split('.')[0] in {'jax', 'flax', 'optax', 'gnn_rul_tpu'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT)},
                         capture_output=True, text=True, timeout=120,
                         check=True)
    assert out.stdout.strip() == "[]"


def test_preprocessors_run_without_pandas(tmp_path, phm_tree,  # noqa: F811
                                         xjtu_tree):  # noqa: F811
    """The C-MAPSS, PHM2012 and XJTU-SY preprocessors on tiny raw trees
    (tests/test_data_{cmapss,bearing}.py's) in a process where importing
    pandas fails."""
    cmapss_root = _write_raw(str(tmp_path / "cmapss"))
    phm_root, _, _ = phm_tree
    xjtu_root, _ = xjtu_tree
    out = tmp_path / "out"
    code = f"""
import sys
sys.modules["pandas"] = None
from gnn_rul_tpu_torch.data import cmapss, phm2012, xjtu_sy
xjtu_sy.RUL_CONDITION_BEARING = {xjtu_sy.RUL_CONDITION_BEARING!r}
c = cmapss.preprocess_cmapss({cmapss_root!r}, "FD001", out_dir={str(out)!r})
p = phm2012.preprocess_phm2012({phm_root!r}, 3, out_dir={str(out)!r})
x = xjtu_sy.preprocess_xjtu_sy({xjtu_root!r}, 1, out_dir={str(out)!r})
print(c["train_x"].shape, sorted(p["test_x"]), sorted(x))
"""
    got = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         env={**os.environ, "PYTHONPATH": str(ROOT)},
                         capture_output=True, text=True, timeout=120)
    assert got.returncode == 0, got.stderr
    assert got.stdout.startswith("(")
    assert "['Bearing3_3'] [1, 2, 3, 4, 5]" in got.stdout

