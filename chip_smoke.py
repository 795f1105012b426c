#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gnn_rul_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; needs CUDA, ``nvcc`` (on PATH or under
``$CUDA_HOME``, default ``/usr/local/cuda``) and writes the built kernels to
``build/``. Phases, in order; any failure raises and the exit code is not 0:

1. device: CUDA must be present; the card's name and power limit;
2. build: every kernel, from the sources in the checkout, one nvcc each,
   all at once;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, on seeded inputs at the serving and training shapes and at ragged
   shapes: the forward, then the backward (dh, dx, the batch-summed dmask);
4. serve: FC_STGNN/FD001 at full width with seeded weights through
   ``serving_model``; every answer against the same weights on the CPU, and
   the forward kernel's launches counted over that run alone;
5. train, parity: 5 steps at batch 100 on the card and on the CPU from the
   same weights on the same batches; losses and parameters compared, the
   backward kernels' launches counted;
6. train, entry point: ``cli.main`` trains one epoch of a synthetic
   processed FD001 at the real size on the card, with both kernels'
   launches counted over that run alone; its results.csv and checkpoint.pt
   are read back, and the checkpoint serves on the card as on the CPU;
7. times: CUDA-event medians of each kernel and its plain version, the
   serving latency and samples/s, the training step and epoch, and
   torch.profiler breakdowns of one request and one training step.

The line before the last is one JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import re
import statistics
import subprocess
import tempfile
import time

import numpy as np
import torch

from gnn_rul_tpu_torch import cli
from gnn_rul_tpu_torch.configs.hparams import train_params
from gnn_rul_tpu_torch.data.io import save_processed
from gnn_rul_tpu_torch.export import build_model, serving_model
from gnn_rul_tpu_torch.ops.kernels import build, fused_gnn
from gnn_rul_tpu_torch.ops.windows import decay_mask
from gnn_rul_tpu_torch.train.algorithms import get_algorithm_spec
from gnn_rul_tpu_torch.train.engine import Engine

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM fp32 outside the tensor cores
TOL_ATOL, TOL_RTOL = 1e-5, 1e-4          # kernel vs plain, both fp32
SERVE_ATOL, SERVE_RTOL = 2e-4, 1e-4      # card vs CPU, whole model
SERVE_BATCH = 100                        # FD001 batch_size (hparams.py)
# card vs CPU over training steps: tests/test_parity_training.py:82-96
LOSS_RTOL, LOSS_ATOL, PARAM_MAX_DIFF = 2e-4, 2e-5, 5e-4
PARITY_STEPS = 5
# FD001 at its real size: 100 engines, 20,631 rows, windows of 50 at
# stride 1 -> 15,731 training windows; one test window per engine.
FD001_ENGINES, FD001_ROWS, WINDOW, MAX_RUL = 100, 20631, 50, 125
SMI = ""  # nvidia-smi's name and power limit, beside every time printed
OUR_KERNELS = ("fused_dot_graph_spmm_kernel", "bwd_rows_kernel",
               "bwd_cols_kernel")


def _device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none found")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    global SMI
    SMI = smi.stdout.strip().splitlines()[0]
    print(SMI)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False  # the references compare in fp32
    return torch.cuda.get_device_name(0)


def _build() -> None:
    t0 = time.perf_counter()
    built = build.build_libraries()
    print(f"build: {', '.join(sorted(built))} "
          f"{time.perf_counter() - t0:.2f} s")
    for stem, (_, log) in sorted(built.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"  ptxas {stem}: {line.strip()}")
    fused_gnn.fused_dot_graph_spmm.load()


def _fused_inputs(b: int, n: int, d: int, f: int, seed: int):
    """Seeded fused-chain inputs on the card. h is scaled by D**-0.25 so
    that the logits h_i.h_j have unit variance, as a Linear-projected h has;
    at D=128 unit-normal h gives logits near 40, where fp32 rounding of the
    logits alone (held against fp64) exceeds the tolerance."""
    rng = np.random.default_rng(seed)
    h = rng.normal(size=(b, n, d)) * d ** -0.25
    x = rng.normal(size=(b, n, f))
    mask = (decay_mask(14, 2, 0.7) if n == 28
            else torch.from_numpy(rng.uniform(size=(n, n))))
    return tuple(torch.as_tensor(t, dtype=torch.float32).cuda().contiguous()
                 for t in (h, x, mask))


# (B, N, D, F): the serving shapes (one scale at batch 100 and at 1000),
# ragged shapes, and the per-graph _kernel regime.
KERNEL_CASES = [(100, 28, 16, 16), (1000, 28, 16, 16), (7, 1, 16, 16),
                (5, 5, 3, 7), (6, 33, 16, 16), (3, 130, 16, 16),
                (8, 384, 128, 128)]


def _kernel_vs_plain() -> float:
    kernel = fused_gnn.fused_dot_graph_spmm
    worst = 0.0
    for i, (b, n, d, f) in enumerate(KERNEL_CASES):
        h, x, mask = _fused_inputs(b, n, d, f, seed=i)
        got = kernel(h, x, mask)
        want = fused_gnn.fused_dot_graph_spmm_plain(h, x, mask)
        torch.cuda.synchronize()
        err = (got - want).abs()
        max_err = err.max().item()
        ok = bool((err <= TOL_ATOL + TOL_RTOL * want.abs()).all())
        print(f"kernel vs plain B={b} N={n} D={d} F={f}: "
              f"max_abs_err={max_err:.3e} {'ok' if ok else 'FAIL'}")
        if not ok or not torch.isfinite(got).all():
            raise AssertionError(f"fused_dot_graph_spmm disagrees with its "
                                 f"plain version at B={b} N={n} D={d} F={f}")
        worst = max(worst, max_err)
    return worst


def _bwd_vs_plain() -> float:
    """The backward kernels against the plain backward at every case, dmask
    included. The tolerance is the forward's, against the fp32 plain
    version. Where dS = P (dP - inner) cancels, the fp32 plain version's
    own rounding can exceed it; a component that misses it is held against
    the plain version in fp64 on the card at the same tolerance, which
    passes only if the kernel is the closer of the two to the exact chain."""
    kernel = fused_gnn.fused_dot_graph_spmm
    plain = fused_gnn.fused_dot_graph_spmm_bwd_plain
    worst = 0.0
    for i, (b, n, d, f) in enumerate(KERNEL_CASES):
        h, x, mask = _fused_inputs(b, n, d, f, seed=i)
        g = torch.randn(x.shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(100 + i))
        dh, dx, dmask = kernel.backward(h, x, mask, g, need_dmask=True)
        got = (dh, dx, dmask.sum(dim=0))
        pdh, pdx, pdmask = plain(h, x, mask, g)
        want = (pdh, pdx, pdmask.sum(dim=0))
        torch.cuda.synchronize()
        exact = None
        for name, k, p in zip(("dh", "dx", "dmask"), got, want):
            ref = "fp32 plain"
            err = (k - p).abs()
            ok = bool((err <= TOL_ATOL + TOL_RTOL * p.abs()).all())
            if not ok:
                if exact is None:
                    e = plain(*(t.double() for t in (h, x, mask, g)))
                    exact = (e[0], e[1], e[2].sum(dim=0))
                p64 = exact[("dh", "dx", "dmask").index(name)]
                ref = (f"fp64 plain (fp32 plain off by "
                       f"{(p.double() - p64).abs().max().item():.3e})")
                err = (k.double() - p64).abs()
                ok = bool((err <= TOL_ATOL + TOL_RTOL * p64.abs()).all())
            max_err = err.max().item()
            print(f"backward vs plain B={b} N={n} D={d} F={f} {name}: "
                  f"max_abs_err={max_err:.3e} against the {ref} "
                  f"{'ok' if ok else 'FAIL'}")
            if not ok or not torch.isfinite(k).all():
                raise AssertionError(
                    f"fused_dot_graph_spmm backward disagrees with its plain "
                    f"version in {name} at B={b} N={n} D={d} F={f}")
            worst = max(worst, max_err)
    return worst


def _seeded_state_dict(seed: int = 0):
    """FC_STGNN/FD001 weights from ``seed``, with BN running statistics set
    away from (0, 1) so that eval-mode BN is not the identity."""
    torch.manual_seed(seed)
    sd = build_model("FC_STGNN", "CMAPSS", "FD001").state_dict()
    gen = torch.Generator().manual_seed(seed)
    for k, v in sd.items():
        if k.endswith("running_mean"):
            v.copy_(torch.randn(v.shape, generator=gen) * 0.5)
        elif k.endswith("running_var"):
            v.copy_(torch.rand(v.shape, generator=gen) * 1.5 + 0.5)
    return sd


def _serve():
    """Drive the serving path; return the models, a request of each size and
    the kernel's launches over the run."""
    sd = _seeded_state_dict()
    fixed = serving_model("FC_STGNN", "CMAPSS", "FD001", sd,
                          batch_size=SERVE_BATCH)
    symbolic = serving_model("FC_STGNN", "CMAPSS", "FD001", sd)
    on_cpu = serving_model("FC_STGNN", "CMAPSS", "FD001", sd, device="cpu")
    rng = np.random.default_rng(1)
    requests = [(fixed, rng.normal(size=(n, 14, 50)).astype(np.float32))
                for n in [SERVE_BATCH] * 5 + [37]]
    requests.append((symbolic, rng.normal(size=(1000, 14, 50))
                     .astype(np.float32)))
    forwards = sum(-(-len(x) // (m.meta["input_shape"][0] or len(x)))
                   for m, x in requests)

    kernel = fused_gnn.fused_dot_graph_spmm
    kernel.launches = 0
    answers = [model(x) for model, x in requests]
    torch.cuda.synchronize()
    launches = kernel.launches

    for (_, x), got in zip(requests, answers):
        want = on_cpu(x)
        if got.shape != (len(x),) or not np.isfinite(got).all():
            raise AssertionError(f"serving answer of shape {got.shape} for "
                                 f"{len(x)} rows, or not finite")
        np.testing.assert_allclose(got, want, atol=SERVE_ATOL,
                                   rtol=SERVE_RTOL)
    print(f"serve: {len(requests)} requests, {forwards} forwards, "
          f"fused_dot_graph_spmm launches={launches}; every answer matches "
          f"the CPU (atol={SERVE_ATOL}, rtol={SERVE_RTOL})")
    if launches != 2 * forwards:
        raise AssertionError(f"expected 2 launches per forward (one per "
                             f"scale), got {launches} for {forwards}")
    return fixed, symbolic, requests[0][1], requests[-1][1], launches


def _train_parity() -> None:
    """PARITY_STEPS steps at batch 100 on the card and on the CPU from the
    same weights on the same batches, PE dropout off, cuDNN deterministic
    and without TF32 for this phase."""
    torch.backends.cudnn.deterministic = True
    torch.manual_seed(0)
    sd = build_model("FC_STGNN", "CMAPSS", "FD001").state_dict()
    engines = {}
    for device in ("cuda", "cpu"):
        model = build_model("FC_STGNN", "CMAPSS", "FD001")
        model.load_state_dict(sd)
        model.pe_dropout.p = 0.0
        engines[device] = Engine(model, get_algorithm_spec("FC_STGNN"),
                                 train_params("CMAPSS", "FD001", "FC_STGNN"),
                                 device=device)
    rng = np.random.default_rng(2)
    xs = rng.normal(size=(PARITY_STEPS, SERVE_BATCH, 14, 50)).astype(
        np.float32)
    ys = rng.uniform(size=(PARITY_STEPS, SERVE_BATCH, 1)).astype(np.float32)

    kernel = fused_gnn.fused_dot_graph_spmm
    kernel.launches = kernel.bwd_launches = 0
    card = [engines["cuda"].train_step(torch.from_numpy(x).cuda(),
                                       torch.from_numpy(y).cuda())
            for x, y in zip(xs, ys)]
    torch.cuda.synchronize()
    fwd_launches, bwd_launches = kernel.launches, kernel.bwd_launches
    cpu = [engines["cpu"].train_step(torch.from_numpy(x), torch.from_numpy(y))
           for x, y in zip(xs, ys)]
    torch.backends.cudnn.deterministic = False

    card = np.array([float(v) for v in card])
    cpu = np.array([float(v) for v in cpu])
    cpu_params = dict(engines["cpu"].model.named_parameters())
    param_diff = max((p.detach().cpu() - cpu_params[k].detach()).abs().max()
                     .item()
                     for k, p in engines["cuda"].model.named_parameters())
    print(f"train parity: {PARITY_STEPS} steps at batch {SERVE_BATCH}, losses "
          f"card {card.tolist()} cpu {cpu.tolist()}; max |param card - cpu| "
          f"{param_diff:.3e}; launches forward {fwd_launches}, backward "
          f"{bwd_launches}")
    np.testing.assert_allclose(card, cpu, rtol=LOSS_RTOL, atol=LOSS_ATOL)
    if not param_diff < PARAM_MAX_DIFF:
        raise AssertionError(f"parameters on the card and the CPU differ by "
                             f"{param_diff} after {PARITY_STEPS} steps")
    want_bwd = 2 * fused_gnn.BWD_LAUNCHES_PER_CALL * PARITY_STEPS
    if bwd_launches != want_bwd or fwd_launches != 2 * PARITY_STEPS:
        raise AssertionError(
            f"expected {2 * PARITY_STEPS} forward and {want_bwd} backward "
            f"launches (2 scales per step), got {fwd_launches} and "
            f"{bwd_launches}")


def _write_fd001(root: str, seed: int = 3):
    """A synthetic processed FD001 at the real size, in the layout of the
    C-MAPSS preprocessor: per engine a [0, 1] sensor series, every window
    of 50 at stride 1 labelled with the capped RUL at its last row over
    MAX_RUL; one test window per engine. Returns (train x, train y) in the
    loader's layout and the data root."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(128, 363, FD001_ENGINES)
    lengths = np.floor(lengths * FD001_ROWS / lengths.sum()).astype(int)
    lengths[: FD001_ROWS - lengths.sum()] += 1
    train_x, train_y, test_x, test_y = [], [], [], []
    for length in lengths:
        series = np.clip(0.5 + np.cumsum(
            rng.normal(scale=0.02, size=(length, 14)), axis=0), 0, 1)
        rul = np.minimum(np.arange(length)[::-1], MAX_RUL) / MAX_RUL
        win = np.lib.stride_tricks.sliding_window_view(
            series, WINDOW, axis=0).transpose(0, 2, 1)
        train_x.append(win)
        train_y.append(rul[WINDOW - 1:])
        cut = rng.integers(WINDOW, length)
        test_x.append(series[cut - WINDOW:cut])
        test_y.append(rul[cut - 1])
    train_x = np.concatenate(train_x).astype(np.float32)
    train_y = np.concatenate(train_y).astype(np.float32)[:, None]
    data_dir = os.path.join(root, "Processed_dataset", "CMAPSS", "FD001")
    save_processed(data_dir, "train", train_x, train_y, MAX_RUL)
    save_processed(data_dir, "test", np.stack(test_x).astype(np.float32),
                   np.array(test_y, np.float32)[:, None], MAX_RUL)
    if len(train_x) != FD001_ROWS - FD001_ENGINES * (WINDOW - 1):
        raise AssertionError(f"{len(train_x)} training windows")
    return ((np.ascontiguousarray(train_x.transpose(0, 2, 1)), train_y),
            np.stack(test_x).astype(np.float32).transpose(0, 2, 1),
            os.path.join(root, "Processed_dataset"))


def _train_entry_point(root: str):
    """The main path: ``cli.main`` trains one epoch on the card. Returns
    the training data and the kernels' launches over that run."""
    (train_x, train_y), test_x, data_root = _write_fd001(root)
    save_dir = os.path.join(root, "logs")
    kernel = fused_gnn.fused_dot_graph_spmm
    kernel.launches = kernel.bwd_launches = 0
    t0 = time.perf_counter()
    results = cli.main([
        "--GNN_method", "FC_STGNN", "--dataset", "CMAPSS", "--dataset_id",
        "FD001", "--data_path", data_root, "--save_dir", save_dir,
        "--epochs", "1", "--num_runs", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd_launches, bwd_launches = kernel.launches, kernel.bwd_launches

    run_dir = os.path.join(save_dir, "GNN_RUL", "run_1", "FC_STGNN_run_0")
    with open(os.path.join(run_dir, "logs_run_0.log")) as f:
        losses = [float(v) for v in re.findall(r"loss\t: (\S+)", f.read())]
    with open(os.path.join(run_dir, "results.csv")) as f:
        rows = [line.strip().split(",") for line in f if line.strip()]
    best = results[0][None]
    print(f"train entry point: cli.main, 1 epoch of {len(train_x)} windows "
          f"on the card in {wall:.2f} s (build, upload and evaluation "
          f"included); epoch loss {losses}; best (Score_v1, Score_v2, MAE, "
          f"RMSE) {best}; launches forward {fwd_launches}, backward "
          f"{bwd_launches}")
    if len(losses) != 1 or not np.isfinite(losses[0]):
        raise AssertionError(f"epoch losses {losses}")
    if rows[0] != ["Score_v1", "Score_v2", "MAE", "RMSE"] or len(rows) != 2 \
            or not np.isfinite([float(v) for v in rows[1]]).all():
        raise AssertionError(f"results.csv holds {rows}")
    steps = -(-len(train_x) // SERVE_BATCH)
    evals = -(-len(test_x) // SERVE_BATCH)
    want = (2 * (steps + evals),
            2 * fused_gnn.BWD_LAUNCHES_PER_CALL * steps)
    if (fwd_launches, bwd_launches) != want:
        raise AssertionError(f"expected (forward, backward) launches {want}, "
                             f"got {(fwd_launches, bwd_launches)}")

    ckpt = torch.load(os.path.join(run_dir, "checkpoint.pt"),
                      map_location="cpu", weights_only=True)
    on_card = serving_model("FC_STGNN", "CMAPSS", "FD001", ckpt["model_dict"],
                            batch_size=SERVE_BATCH)
    on_cpu = serving_model("FC_STGNN", "CMAPSS", "FD001", ckpt["model_dict"],
                           device="cpu")
    got, want_pred = on_card(test_x), on_cpu(test_x)
    if got.shape != (len(test_x),) or not np.isfinite(got).all():
        raise AssertionError(f"checkpoint serves {got.shape} or non-finite")
    np.testing.assert_allclose(got, want_pred, atol=SERVE_ATOL,
                               rtol=SERVE_RTOL)
    print(f"train entry point: checkpoint.pt serves {len(test_x)} test "
          f"windows on the card as on the CPU (atol={SERVE_ATOL}, "
          f"rtol={SERVE_RTOL})")
    return (train_x, train_y), fwd_launches, bwd_launches


def _graph_ms(fn, inner: int = 50, reps: int = 21) -> float:
    """Median device ms of one ``fn()``: ``inner`` calls captured in a CUDA
    graph, replayed ``reps`` times between CUDA events, so host launch cost
    stays out of the kernel's time."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def _request_ms(model, x, warmup: int = 5, reps: int = 30) -> float:
    """Median host ms of one request, input on the host to answer on the
    host (the call ends with the copy back, which waits for the card)."""
    for _ in range(warmup):
        model(x)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        model(x)
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def _profile(name: str, fn, untraced_ms: float, unit: str,
             reps: int = 10) -> None:
    """Print the card's time per ``fn()`` by kernel and copy
    (torch.profiler) and its share of ``untraced_ms``, the time of one call
    measured without the profiler (which slows the host down)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        traced_us = (time.perf_counter() - t0) * 1e6 / reps
    # Kernels and copies only: a user annotation (the optimizer's step)
    # spans the kernels it launches and would count them twice.
    on_card = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)),
                     key=lambda e: -e.device_time_total)
    busy_us = sum(e.device_time_total for e in on_card) / reps
    ours_us = sum(e.device_time_total for e in on_card
                  if any(k in e.key for k in OUR_KERNELS)) / reps
    print(f"profile {name} [{SMI}]: card busy {busy_us:.1f} us per {unit}, "
          f"{100 * busy_us / (untraced_ms * 1e3):.1f}% of the untraced "
          f"{unit} (traced {unit} {traced_us:.1f} us); the port's kernels "
          f"{ours_us:.1f} us ({100 * ours_us / busy_us:.1f}% of busy); "
          f"by kernel:")
    for e in on_card[:16]:
        print(f"  {e.device_time_total / reps:9.1f} us  "
              f"x{e.count / reps:g}  {e.key[:72]}")


def _bound_ms(b: int, n: int, d: int, f: int, backward: bool = False):
    """Least time for the chain on an H100 SXM, the larger of its bytes at
    the HBM rate and its fp32 operations at the fp32 peak. Forward: h, x,
    mask read and out written; 2*B*N^2*(D+F) operations. Backward without
    dmask: h, x, g, mask read and dh, dx written; 2*B*N^2*(3D+2F)
    operations (S, dA, dx, dS h, dS^T h)."""
    if backward:
        nbytes = 4 * (2 * b * n * d + 3 * b * n * f + n * n)
        flops = 2 * b * n * n * (3 * d + 2 * f)
    else:
        nbytes = 4 * (b * n * d + 2 * b * n * f + n * n)
        flops = 2 * b * n * n * (d + f)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOP_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def _kernel_times(name: str, shapes, kernel_fn, plain_fn, backward: bool):
    """{shape: (kernel ms, plain ms, bound ms, bound by)} at ``shapes``."""
    times = {}
    for shape in shapes:
        h, x, mask = _fused_inputs(*shape, seed=0)
        g = torch.randn(x.shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
        args = (h, x, mask, g) if backward else (h, x, mask)
        times[shape] = (_graph_ms(lambda: kernel_fn(*args)),
                        _graph_ms(lambda: plain_fn(*args)),
                        *_bound_ms(*shape, backward=backward))
        print(f"times [{SMI}]: {name} B={shape[0]} N={shape[1]} "
              f"D={shape[2]} F={shape[3]}: " + "kernel {:.6f} ms, plain "
              "{:.6f} ms, bound {:.6f} ms ({})".format(*times[shape]))
    return times


def _step_ms(engine: Engine, x, y, warmup: int = 5, reps: int = 30) -> float:
    """Median host ms of one training step, synchronised after each."""
    for _ in range(warmup):
        engine.train_step(x, y)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        engine.train_step(x, y)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main() -> None:
    kind = _device()
    _build()
    max_err = _kernel_vs_plain()
    bwd_max_err = _bwd_vs_plain()
    fixed, symbolic, x100, x1000, serve_launches = _serve()
    _train_parity()
    with tempfile.TemporaryDirectory() as tmp:
        data, fwd_launches, bwd_launches = _train_entry_point(tmp)

    kernel = fused_gnn.fused_dot_graph_spmm
    fwd = _kernel_times("fused_dot_graph_spmm", KERNEL_CASES[:2], kernel,
                        fused_gnn.fused_dot_graph_spmm_plain, backward=False)
    bwd = _kernel_times("fused_dot_graph_spmm_bwd", KERNEL_CASES[:2],
                        kernel.backward,
                        fused_gnn.fused_dot_graph_spmm_bwd_plain,
                        backward=True)
    for name, model, xs in (("batch 100", fixed, x100),
                            ("batch 1000", symbolic, x1000)):
        req_ms = _request_ms(model, xs)
        x_dev = torch.from_numpy(xs).cuda()
        with torch.inference_mode():
            fwd_ms = _graph_ms(lambda: model.model(x_dev), inner=10)
        print(f"serve {name} [{SMI}]: {req_ms:.4f} ms/request, "
              f"{len(xs) / req_ms * 1e3:.1f} samples/s; the forward's device "
              f"work alone (CUDA graph) {fwd_ms:.4f} ms")
        _profile(f"serve {name}", lambda: model(xs), req_ms, "request")

    train_x, train_y = data
    torch.manual_seed(0)
    engine = Engine(build_model("FC_STGNN", "CMAPSS", "FD001"),
                    get_algorithm_spec("FC_STGNN"),
                    train_params("CMAPSS", "FD001", "FC_STGNN"))
    xb = torch.from_numpy(train_x[:SERVE_BATCH]).cuda()
    yb = torch.from_numpy(train_y[:SERVE_BATCH]).cuda()
    step_ms = _step_ms(engine, xb, yb)
    engine.run_epoch(train_x, train_y, 1, shuffle=True)  # the data's upload
    t0 = time.perf_counter()
    engine.run_epoch(train_x, train_y, 2, shuffle=True)
    epoch_s = time.perf_counter() - t0
    steps = -(-len(train_x) // SERVE_BATCH)
    print(f"train [{SMI}]: {step_ms:.4f} ms per step at batch {SERVE_BATCH} "
          f"(median of 30); one epoch of {len(train_x)} windows in "
          f"{steps} steps {epoch_s:.4f} s, {len(train_x) / epoch_s:.1f} "
          f"samples/s; backward launches per step "
          f"{2 * fused_gnn.BWD_LAUNCHES_PER_CALL}")
    _profile("train step", lambda: engine.train_step(xb, yb), step_ms,
             "step")

    def entry(name, times, max_abs_err, launches, **extra):
        ms, plain_ms, bound_ms, bound_by = times[KERNEL_CASES[0]]
        return {"name": name, "route": "cuda", **extra,
                "launches": launches, "max_abs_err": max_abs_err, "ms": ms,
                "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": None}

    print(json.dumps({"kernels": [
        entry("fused_dot_graph_spmm", fwd, max_err, fwd_launches,
              source="gnn_rul_tpu_torch/csrc/fused_gnn.cu",
              replaces="gnn_rul_tpu/ops/pallas/fused_gnn.py:45 (_kernel), "
                       "gnn_rul_tpu/ops/pallas/fused_gnn.py:116 "
                       "(_packed_kernel)",
              launches_serve=serve_launches),
        entry("fused_dot_graph_spmm_bwd", bwd, bwd_max_err, bwd_launches,
              source="gnn_rul_tpu_torch/csrc/fused_gnn_bwd.cu",
              replaces="gnn_rul_tpu/ops/pallas/fused_gnn.py:235 "
                       "(_bwd_kernel)"),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
