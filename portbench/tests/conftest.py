"""Fixtures of the benchmark's tests: a cell at a tiny traffic, run on the
CPU through the runners (the harness's look for a card skipped), and the
card for the tests marked ``cuda``, decided here and never at import."""

from __future__ import annotations

import dataclasses
import sys
import types
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TINY = {"sizes": [2, 9, 5, 9], "pool_windows": 64,
        "check_requests": 3}


def tiny_cell(workload: str):
    """The cell with requests of 2-9 windows from a pool of 64."""
    from portbench.harness import cell as cells
    cell = cells.load(workload)
    return dataclasses.replace(cell, traffic={**cell.traffic, **TINY})


def run_cell(cell, seed: int = 2 ** 31 + 11, seconds: float = 0.5,
             trace: int = 0, device=None):
    import time

    import torch

    from portbench.harness import cell as cells
    args = types.SimpleNamespace(seed=seed, seconds=seconds, trace=trace)
    return cells.runner(cell.traffic["kind"]).run(
        cell, args, device or torch.device("cpu"), time.perf_counter())


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)
