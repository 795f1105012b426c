"""The check that decides ``correct`` fails a run whose timed path is
broken underneath: a run of each serving cell on the CPU (the harness's
look for a card skipped), sound and with the program's ``ServingModel``
answering wrong: one answer altered, half of a request left out, every
answer shifted. The widest gap catches the first, the median the other
two. And without a card the benchmark prints no result."""

import subprocess
import sys

import numpy as np
import pytest

from portbench.harness.cell import ROOT
from portbench.tests.conftest import run_cell, tiny_cell

SERVING = ["hagcn-fd001.serve", "logo_bearing-phm2012.serve",
           "fc_stgnn-fd003.serve"]


def _altered(call):
    """One answer of each request altered where it is produced: the first
    window given the second's answer."""
    def broken(self, x):
        y = np.array(call(self, x))
        y[0] = y[1]
        return y
    return broken


def _half(call):
    """Half of each request left out: its first half served, the answers
    repeated."""
    def broken(self, x):
        return np.resize(call(self, x[:max(1, len(x) // 2)]), len(x))
    return broken


def _shifted(call):
    """Every answer altered where it is produced, by a thousandth."""
    def broken(self, x):
        return np.asarray(call(self, x)) * np.float32(1.001)
    return broken


@pytest.mark.parametrize("workload", SERVING)
def test_a_sound_run_is_correct(workload):
    result = run_cell(tiny_cell(workload))
    assert result.correct, result.compared
    assert result.attempted > 0 and result.failed == 0


@pytest.mark.parametrize("fault", [_altered, _half, _shifted])
@pytest.mark.parametrize("workload", SERVING)
def test_a_broken_timed_path_is_not_correct(workload, fault, monkeypatch):
    from gnn_rul_tpu_torch.export import ServingModel
    monkeypatch.setattr(ServingModel, "__call__",
                        fault(ServingModel.__call__))
    result = run_cell(tiny_cell(workload))
    assert not result.correct, result.compared


def test_without_a_card_there_is_no_result():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "hagcn-fd001.serve", "--seed", "1", "--seconds", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA card" in out.stderr
