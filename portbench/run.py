"""Run one cell of the port's benchmark and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json`` beside the
``gnn_rul_tpu_torch`` package. The cell (a configuration under a traffic
mix) is found by name in ``BENCHMARK.json``; its configuration, mix,
reference and metric readers by the names there (``portbench/README.md``).
Without a card, or with fewer than the cell asks for, it exits with code 2
and prints no result. With ``--trace 0`` the result holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, read from a
profiler trace of the window.
"""

from __future__ import annotations

import time

CLOCK_START = time.perf_counter()   # the process's start, for setup_s

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Every cache the program or a library writes stays at a fixed path inside
# the checkout, so that only a checkout's first run builds anything. The
# kernels themselves are built into ``build/`` at the checkout's root by
# ``gnn_rul_tpu_torch/ops/kernels/build.py``.
CACHE = ROOT / ".portbench_cache"
for var, sub in (("TRITON_CACHE_DIR", "triton"),
                 ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor")):
    os.environ[var] = str(CACHE / sub)
os.environ["USE_FLAX"] = "0"
sys.path[0] = str(ROOT)   # the checkout, not portbench/, on the path

FORBIDDEN = ("jax", "jaxlib", "flax", "gnn_rul_tpu")
HOST_THREADS = 1   # torch's intra-op threads, fixed in every run


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or the
    JAX package's (``gnn_rul_tpu_torch`` is neither)."""
    return sorted({name.split(".")[0] for name in sys.modules}
                  & set(FORBIDDEN))


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if args.seed < 0 or args.seconds <= 0:
        ap.error("--seed must be >= 0 and --seconds > 0")
    return args


def _number(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else None


def result_line(cell, result, trace: bool) -> dict:
    """The result's JSON object, its ``compared`` entry last."""
    from portbench.harness.cell import base_name, reader
    from portbench.harness.trace import idle_gaps, top_device_ops

    metrics, device = {}, dict(result.device)
    if not trace:
        for m in cell.end_to_end:
            quantity = base_name(m["name"], result.metrics.__contains__)
            metrics[m["name"]] = {"value": result.metrics[quantity],
                                  "unit": m["unit"]}
    else:
        readings = result.readings
        for m in cell.per_layer:
            value = reader(m["name"])(readings)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    line = {"correct": result.correct, "attempted": result.attempted,
            "failed": result.failed, "metrics": metrics, "device": device}
    if trace and result.readings.trace is not None:
        tr = result.readings.trace
        device["busy_s"] = tr.busy_s()
        device["window_s"] = tr.window_s
        line["breakdown"] = {"device_ops": top_device_ops(tr),
                             "idle_gaps": idle_gaps(tr)}
    line["compared"] = {k: {"value": _number(v["value"]), "limit": v["limit"]}
                        for k, v in result.compared.items()}
    return line


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from portbench.harness import cell as cells
    cell = cells.load(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"{args.workload} needs {cell.chips} CUDA card(s); found "
              f"{found}. The benchmark measures the card and never falls "
              "back to the CPU.", file=sys.stderr)
        return 2
    torch.set_num_threads(HOST_THREADS)
    torch.backends.cuda.matmul.allow_tf32 = bool(cell.config["tf32"])
    torch.backends.cudnn.allow_tf32 = bool(cell.config["tf32"])
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    result = cells.runner(cell.traffic["kind"]).run(cell, args, device,
                                                    CLOCK_START)
    line = result_line(cell, result, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    for note in result.notes:
        print(note, file=sys.stderr)
    for name, c in line["compared"].items():
        print(f"compared {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
