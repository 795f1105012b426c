"""The serving runner: one client in a closed loop against the port's
``ServingModel``, then the answers of a sample of its requests held
against the configuration's plain reference.

The mix (``traffic/<name>.json``, kind ``serve``) lists the request sizes
in windows, taken from its ``source``; they are sent in cycles, each cycle
every entry once in an order drawn from the seed, so that every seed sends
the same sizes and only their order and contents differ; each request is
``n`` consecutive windows of a pool of ``pool_windows`` made from the
seed, from an offset drawn from the seed. Set-up serves every distinct
size once. The window then sends requests until
``--seconds`` have passed and the last one has been answered.
"""

from __future__ import annotations

import gc
import time
from typing import List

import numpy as np

from .cell import Cell, Readings, Result
from .common import (device_info, make_weights, make_windows, percentile,
                     rel_gaps, rng)
from .trace import traced_window

REQUEST_SPAN = "portbench.request"


def sizes_of(mix: dict) -> List[int]:
    """The sizes of one cycle of requests."""
    return [int(n) for n in mix["sizes"]]


def schedule(mix: dict, seed: int, pool: int, count: int):
    """The first ``count`` requests' ``(sizes, offsets)``."""
    gen = rng(seed, "traffic.schedule")
    levels = np.asarray(sizes_of(mix))
    cycles = -(-count // len(levels))
    sizes = np.concatenate([gen.permutation(levels) for _ in range(cycles)])
    offsets = gen.integers(0, pool - sizes + 1)
    return sizes[:count].tolist(), offsets[:count].tolist()


def build(cell: Cell, seed: int, device):
    """The served model with weights from the seed, and those weights."""
    from gnn_rul_tpu_torch.configs.hparams import model_hparams
    from gnn_rul_tpu_torch.export import serving_model

    cfg = cell.config
    bank = model_hparams(cfg["dataset"], cfg["dataset_id"], cfg["method"])
    if bank != cfg["model"]:
        raise SystemExit(f"the program's hparam bank gives {bank} for "
                         f"{cfg['method']}, the configuration {cfg['model']}")
    weights = make_weights(cell.reference.param_specs(cfg), seed, device)
    model = serving_model(cfg["method"], cfg["dataset"], cfg["dataset_id"],
                          weights, batch_size=None, device=str(device))
    return model, weights


def prepare(cell: Cell, seed: int, device):
    """Set-up: the model, its weights, the pool and the schedule, then
    every request size served once."""
    mix = cell.traffic
    model, weights = build(cell, seed, device)
    pool = make_windows(cell.config["input"], mix["pool_windows"],
                        rng(seed, "traffic.pool"))
    sizes, offsets = schedule(mix, seed, len(pool), int(mix["max_requests"]))
    marks = [time.perf_counter()]
    for n in sorted(set(sizes)):
        model(pool[:n])
        marks.append(time.perf_counter())
    return model, weights, pool, sizes, offsets, marks


def window(model, pool, sizes, offsets, seconds: float, traced: bool):
    """The closed loop: requests until ``seconds`` have passed and the
    last one is answered. ``(answers, latencies, wall)``."""
    if traced:
        from torch.profiler import record_function
    answers, latencies = [], []
    t0 = time.perf_counter()
    deadline = t0 + seconds
    for i in range(len(sizes)):
        x = pool[offsets[i]:offsets[i] + sizes[i]]
        ts = time.perf_counter()
        if traced:
            with record_function(REQUEST_SPAN):
                y = model(x)
        else:
            y = model(x)
        te = time.perf_counter()
        answers.append(y)
        latencies.append(te - ts)
        if te >= deadline:
            break
    return answers, latencies, te - t0


def run(cell: Cell, args, device, clock_start: float) -> Result:
    import torch

    start = time.perf_counter()
    model, weights, pool, sizes, offsets, marks = prepare(cell, args.seed,
                                                          device)
    if device.type == "cuda":
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - clock_start
    collections = [g["collections"] for g in gc.get_stats()]
    with traced_window(bool(args.trace), device) as profiled:
        answers, latencies, wall = window(model, pool, sizes, offsets,
                                          args.seconds, bool(args.trace))
    collections = [g["collections"] - c
                   for g, c in zip(gc.get_stats(), collections)]
    dev = device_info(device, cell.chips)
    done = sizes[:len(answers)]
    metrics = {"serve_windows_per_s": sum(done) / wall,
               "serve_p95_ms": percentile(latencies, 95) * 1e3,
               "setup_s": setup_s}
    readings = None
    if args.trace:
        readings = Readings(cell.config, cell.counts, profiled.trace,
                            {"request": list(done)})
    notes = [f"set-up: {setup_s:.3f} s; {start - clock_start:.3f} to the "
             f"runner, {marks[0] - start:.3f} building the model, the pool "
             f"and the schedule, {marks[-1] - marks[0]:.3f} serving every "
             f"size once (the first {marks[1] - marks[0]:.3f})",
             f"window: {len(done)} requests, {sum(done)} windows in "
             f"{wall:.3f} s; garbage collections by generation "
             f"{collections}"]

    # The check, once the window has closed and the program is freed.
    del model
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    compared, failed, more = check(cell, args.seed, weights, pool, done,
                                   offsets[:len(done)], answers, device)
    return Result(metrics, len(done), failed, compared, dev, readings,
                  notes + more)


def sample(seed: int, sizes: List[int], k: int) -> List[int]:
    """``k`` of the requests answered, drawn from the seed, the longest
    (the first of them) among them."""
    longest = int(np.argmax(sizes))
    rest = [j for j in range(len(sizes)) if j != longest]
    picked = rng(seed, "check.sample").choice(
        len(rest), size=min(k - 1, len(rest)), replace=False)
    return sorted([longest] + [rest[j] for j in picked])


def reference_answers(cell: Cell, weights, pool, sizes, offsets, picks,
                      device, dtype=None) -> List[np.ndarray]:
    """The reference's answers to the picked requests, at ``dtype``
    (float64 by default)."""
    import torch

    dtype = dtype or torch.float64
    params = {k: v.to(dtype) for k, v in weights.items()}
    xs = [torch.as_tensor(pool[offsets[j]:offsets[j] + sizes[j]],
                          device=device) for j in picks]
    with torch.no_grad():
        outs = cell.reference.forward(params, cell.config, xs)
    return [o.cpu().numpy() for o in outs]


def gap_numbers(answers, refs) -> dict:
    """The widest and the median gap over every answer of the requests; a
    request whose answers are missing or not finite makes both nan."""
    gaps, bad = rel_gaps(answers, refs)
    if bad or not gaps.size:
        return {"answer_gap_max": float("nan"),
                "answer_gap_median": float("nan")}
    return {"answer_gap_max": float(gaps.max()),
            "answer_gap_median": float(np.median(gaps))}


def check(cell: Cell, seed: int, weights, pool, sizes, offsets, answers,
          device):
    """Every answer's shape and finiteness, and the gaps of a sample of
    requests against the reference at float64: ``(compared, failed,
    notes)``. The configuration's ``check`` names the gaps compared and
    their limits."""
    failed = sum(1 for y, n in zip(answers, sizes)
                 if np.shape(y) != (n,) or not np.all(np.isfinite(y)))
    picks = sample(seed, sizes, int(cell.traffic["check_requests"]))
    t0 = time.perf_counter()
    refs = reference_answers(cell, weights, pool, sizes, offsets, picks,
                             device)
    nums = gap_numbers([answers[j] for j in picks], refs)
    compared = {name: {"value": nums[name], "limit": limit}
                for name, limit in cell.config["check"].items()}
    compared["failed_requests"] = {"value": failed, "limit": 0}
    notes = [f"check: requests {picks} ({sum(sizes[j] for j in picks)} "
             f"windows) against the float64 reference in "
             f"{time.perf_counter() - t0:.3f} s; widest gap "
             f"{nums['answer_gap_max']}, median {nums['answer_gap_median']}"]
    return compared, failed, notes
