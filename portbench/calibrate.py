"""The readings that the limits of a serving cell's check are set from, at
the cell's own size and load, all seeds in one process.

    python3 portbench/calibrate.py --workload <name> --seeds 1,2,... \\
        --control-seeds 1,2,3 --seconds 3

For each seed: a short window of the cell's closed loop through the
program, then the check's numbers for the program's answers. For each
control seed besides: the same numbers for the control, the reference in
the program's place computed at float32 with TF32 on (the precision next
below the configuration's float32 with TF32 off); for the reference at
float32 with TF32 off; and for three faults of the timed path: one answer
of each request altered (each request's first answer given its second's),
half of each request left out (its first half served and its answers
repeated), and every answer shifted by a thousandth. One JSON line a
seed; the benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[0] = str(ROOT)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)
    import numpy as np
    import torch

    from portbench.harness import cell as cells
    from portbench.harness import serve

    cell = cells.load(args.workload)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    device = torch.device("cuda", 0)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        model, weights, pool, sizes, offsets, _ = serve.prepare(
            cell, seed, device)
        answers, _, wall = serve.window(model, pool, sizes, offsets,
                                        args.seconds, False)
        done = sizes[:len(answers)]
        picks = serve.sample(seed, done, int(cell.traffic["check_requests"]))
        refs = serve.reference_answers(cell, weights, pool, done, offsets,
                                       picks, device)
        out = {"seed": seed, "requests": len(done), "window_s": wall,
               "picked_windows": sum(done[j] for j in picks),
               "program": serve.gap_numbers([answers[j] for j in picks],
                                            refs),
               "reference_rms": [float(np.sqrt(np.mean(r * r)))
                                 for r in refs]}
        if seed in controls:
            for name, tf32 in (("control_tf32", True), ("reference_fp32",
                                                         False)):
                torch.backends.cuda.matmul.allow_tf32 = tf32
                torch.backends.cudnn.allow_tf32 = tf32
                ctl = serve.reference_answers(cell, weights, pool, done,
                                              offsets, picks, device,
                                              torch.float32)
                out[name] = serve.gap_numbers(ctl, refs)
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False
            altered = []
            for j in picks:
                a = np.array(answers[j])
                a[0] = a[1]
                altered.append(a)
            out["fault_answer_altered"] = serve.gap_numbers(altered, refs)
            halves = []
            for j in picks:
                x = pool[offsets[j]:offsets[j] + done[j]]
                half = model(x[:done[j] // 2])
                halves.append(np.resize(half, done[j]))
            out["fault_half_batch"] = serve.gap_numbers(halves, refs)
            out["fault_shifted"] = serve.gap_numbers(
                [np.asarray(answers[j]) * np.float32(1.001) for j in picks],
                refs)
        del model
        torch.cuda.empty_cache()
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
