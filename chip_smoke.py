#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gnn_rul_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; needs CUDA, ``nvcc`` (on PATH or under
``$CUDA_HOME``, default ``/usr/local/cuda``) and writes the built kernel to
``build/``. Phases, in order; any failure raises and the exit code is not 0:

1. device: CUDA must be present; the card's name and power limit;
2. build: every kernel of the path, from the sources in the checkout;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, on seeded inputs at the serving shapes and at ragged shapes;
4. serve: FC_STGNN/FD001 at full width with seeded weights through
   ``serving_model``; every answer against the same weights on the CPU, and
   the kernel's launches counted over that run alone;
5. times: CUDA-event medians of each kernel and its plain version, the
   serving latency and samples/s, and a torch.profiler breakdown of one
   request's time on the card.

The line before the last is one JSON object ``{"kernels": [...]}``; the last
line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import time

import numpy as np
import torch

from gnn_rul_tpu_torch.export import build_model, serving_model
from gnn_rul_tpu_torch.ops.kernels import fused_gnn
from gnn_rul_tpu_torch.ops.windows import decay_mask

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM fp32 outside the tensor cores
TOL_ATOL, TOL_RTOL = 1e-5, 1e-4          # kernel vs plain, both fp32
SERVE_ATOL, SERVE_RTOL = 2e-4, 1e-4      # card vs CPU, whole model
SERVE_BATCH = 100                        # FD001 batch_size (hparams.py)


def _device() -> str:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device; none found")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False  # the references compare in fp32
    return torch.cuda.get_device_name(0)


def _build() -> None:
    t0 = time.perf_counter()
    log = fused_gnn.fused_dot_graph_spmm.load()
    print(f"build: fused_gnn {time.perf_counter() - t0:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")


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


def _profile_request(name: str, model, x, req_ms: float,
                     reps: int = 10) -> None:
    """Print the card's time per request by kernel and copy (torch.profiler)
    and its share of ``req_ms``, the request time measured without the
    profiler (which slows the host down)."""
    model(x)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            model(x)
        traced_us = (time.perf_counter() - t0) * 1e6 / reps
    on_card = sorted((e for e in prof.key_averages()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: -e.device_time_total)
    busy_us = sum(e.device_time_total for e in on_card) / reps
    print(f"profile {name}: card busy {busy_us:.1f} us per request, "
          f"{100 * busy_us / (req_ms * 1e3):.1f}% of the untraced request "
          f"(traced request {traced_us:.1f} us); by kernel:")
    for e in on_card[:8]:
        print(f"  {e.device_time_total / reps:9.1f} us  "
              f"x{e.count / reps:g}  {e.key[:72]}")


def _bound_ms(b: int, n: int, d: int, f: int):
    """Least time for the chain on an H100 SXM: h, x, mask read once and out
    written once at the HBM rate, or 2*B*N^2*(D+F) fp32 operations at the
    fp32 peak, whichever is larger."""
    nbytes = 4 * (b * n * d + 2 * b * n * f + n * n)
    flops = 2 * b * n * n * (d + f)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOP_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def main() -> None:
    kind = _device()
    _build()
    max_err = _kernel_vs_plain()
    fixed, symbolic, x100, x1000, launches = _serve()

    times = {}
    for shape in KERNEL_CASES[:2]:  # one scale at batch 100, at 1000
        h, x, mask = _fused_inputs(*shape, seed=0)
        args = (h, x, mask)
        times[shape] = (
            _graph_ms(lambda: fused_gnn.fused_dot_graph_spmm(*args)),
            _graph_ms(lambda: fused_gnn.fused_dot_graph_spmm_plain(*args)),
            *_bound_ms(*shape))
        print("times: fused_dot_graph_spmm B={} N={} D={} F={}: ".format(
            *shape) + "kernel {:.6f} ms, plain {:.6f} ms, bound {:.6f} ms "
              "({})".format(*times[shape]))
    ms, plain_ms, bound_ms, bound_by = times[KERNEL_CASES[0]]
    for name, model, xs in (("batch 100", fixed, x100),
                            ("batch 1000", symbolic, x1000)):
        req_ms = _request_ms(model, xs)
        x_dev = torch.from_numpy(xs).cuda()
        with torch.inference_mode():
            fwd_ms = _graph_ms(lambda: model.model(x_dev), inner=10)
        print(f"serve {name}: {req_ms:.4f} ms/request, "
              f"{len(xs) / req_ms * 1e3:.1f} samples/s; the forward's device "
              f"work alone (CUDA graph) {fwd_ms:.4f} ms")
        _profile_request(name, model, xs, req_ms)

    print(json.dumps({"kernels": [{
        "name": "fused_dot_graph_spmm",
        "route": "cuda",
        "source": "gnn_rul_tpu_torch/csrc/fused_gnn.cu",
        "replaces": "gnn_rul_tpu/ops/pallas/fused_gnn.py:45 (_kernel), "
                    "gnn_rul_tpu/ops/pallas/fused_gnn.py:116 (_packed_kernel)",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "kernel_ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
