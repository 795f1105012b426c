"""A cell as ``BENCHMARK.json`` names it, with everything found by name:
its configuration's file, reference and counts, its traffic mix's file,
and the readers of its per-layer metrics.

Nothing here names a cell, a configuration, a mix or a metric: a later
change adds one by adding its files and its entries.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]
BENCH_DIR = ROOT / "portbench"


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    reference: ModuleType
    counts: ModuleType
    end_to_end: List[dict]
    per_layer: List[dict]


@dataclass
class Readings:
    """What a per-layer reader reads: the configuration and its counts, the
    trace of the window (None with ``--trace 0`` or without a card), and
    the windows of each call the window made into the program, by kind
    (``request``: a serving request)."""
    config: dict
    counts: ModuleType
    trace: object = None
    calls: Dict[str, List[int]] = field(default_factory=dict)


@dataclass
class Result:
    """A runner's run: every end-to-end metric it measured (the harness
    reports those of the cell), the requests or steps attempted and failed,
    the numbers compared with their limits, the ``device`` entry, and the
    readings of a traced window."""
    metrics: Dict[str, float]
    attempted: int
    failed: int
    compared: Dict[str, dict]
    device: dict
    readings: Optional[Readings] = None
    notes: List[str] = field(default_factory=list)

    @property
    def correct(self) -> bool:
        return self.failed == 0 and all(
            c["value"] <= c["limit"] for c in self.compared.values())


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load(workload: str, root: Path = ROOT) -> Cell:
    bench = load_json(root / "BENCHMARK.json")
    by_name = {w["name"]: w for w in bench["workloads"]}
    if workload not in by_name:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json; "
                         f"there are {sorted(by_name)}")
    wl = by_name[workload]
    entry = {c["name"]: c for c in bench["configs"]}[wl["config"]]
    config = load_json(root / entry["file"])
    traffic = load_json(root / "portbench" / "traffic"
                        / f"{wl['traffic']}.json")
    e2e = [m for m in bench["end_to_end"]
           if workload in m.get("workloads", [workload])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if (workload in m["workloads"] if "workloads" in m
                     else m["moves"] in names)]
    return Cell(workload, int(wl["chips"]), config, traffic,
                importlib.import_module(
                    f"portbench.reference.{config['reference']}"),
                importlib.import_module(f"portbench.counts.{config['counts']}"),
                e2e, per_layer)


def base_name(name: str, known: Callable[[str], bool]) -> str:
    """The longest of ``name`` and its dotted prefixes that is ``known``: a
    metric ``X.host_paced`` is quantity ``X`` in the cells it lists, under
    a bound of its own."""
    while not known(name) and "." in name:
        name = name.rsplit(".", 1)[0]
    return name


def reader(metric: str, root: Path = ROOT) -> Callable[[Readings],
                                                        Optional[float]]:
    """The ``read`` function of ``portbench/metrics/<metric>.py``, or of
    the file of its longest dotted prefix that has one."""
    metrics = root / "portbench" / "metrics"
    metric = base_name(metric, lambda n: (metrics / f"{n}.py").is_file())
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        metrics / f"{metric}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def runner(kind: str) -> ModuleType:
    """The runner of a traffic mix's ``kind``: ``portbench/harness/<kind>.py``
    exposes ``run(cell, args, device, clock_start) -> Result``."""
    return importlib.import_module(f"portbench.harness.{kind}")
