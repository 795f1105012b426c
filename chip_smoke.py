#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (gnn_rul_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout; needs CUDA, ``nvcc`` (on PATH or under
``$CUDA_HOME``, default ``/usr/local/cuda``) and writes the built kernels to
``build/``. Phases, in order; any failure raises and the exit code is not 0:

1. device: CUDA must be present; the card's name and power limit;
2. build: every kernel, from the sources in the checkout, one nvcc each,
   all at once; the plans the libraries choose (the LSTM's, the dot-graph
   forward's whole-graph plan and the backward's one-launch threshold in N,
   the attention's), held against the wrappers' own;
3. kernel vs plain: each kernel against its plain PyTorch version on the
   card, on seeded inputs at the serving and training shapes and at ragged
   shapes: the dot-graph forward (also on each side of every point where
   its plan changes: the whole-graph threshold in N, graphs a block, row
   tiles a graph), then its backward (dh, dx, the
   batch-summed dmask; also on each side of its one-launch threshold); the
   LSTM recurrence forward (ys, the c trajectory,
   c_fin), then its backward's gate pass (the activated gates) and the
   whole backward (dxg, dw_hh, with both outputs' cotangents nonzero), at
   LOGO's, HAGCN's, LOGO_bearing's, ragged and H = 1024 (T, B, H), and on
   each side of every point where the kernels' plan changes, in H at two
   B and in B at two H (each cluster size included); the graph attention
   at STAGNN's and STFA's (B, N, D), both adjacency layouts, GAT_LSTM's D
   and GDAGDL's N, ragged shapes, and on each side of every point where
   its plan changes;
4. serve: FC_STGNN, LOGO, STAGNN, STFA, HAGCN, RGCNU, GRU_CM, STGNN,
   DVGTformer, HierCorrPool, ASTGCNN and ST_Conv on FD001, at full width
   with seeded weights through ``serving_model``; every answer against the
   same weights on the CPU at the same batch, and each path's kernel
   launches counted over that path's run alone (every other wrapper's count
   must stay 0: the last seven launch no port kernel); then the tier
   configurations, HierCorrPool at FD004's hparams and DVGTformer at
   N-CMAPSS's (20 sensors), card against CPU at 100 and 1000 rows, no
   launch; for STAGNN, whose graph is ``cov > 0``, the smallest |cov|
   and the adjacency entries that differ between card and CPU; for HAGCN
   and STGNN, which select by top-k, the CPU replays the card's selections
   and the smallest gap between the k-th and (k+1)-th score and the
   selections that differ are printed (:class:`_Selections`);
5. artifacts: for each model, ``export_serving`` for the card at a
   symbolic batch and at batch 100 (traced on the CPU and moved to the
   card at export), and for the CPU at a symbolic batch; each saved with
   ``save_artifact`` and loaded on the card with ``load_artifact`` (the
   CPU's moved there at load); the registered operator's
   nodes counted in each exported graph; phase 4's requests served through
   each (the 1000-row one through the symbolic ones), every answer held
   against the live model on the card at the same batch, and each
   artifact's kernel launches counted over its own requests;
6. train, parity: for each model, 5 steps at batch 100 on the card and on
   the CPU from the same weights on the same batches, dropout off; losses
   and parameters compared (where either misses, both sides against the
   same steps in fp64 on the CPU, the card to be within the same tolerance
   of them and the closer), for HAGCN and HierCorrPool the gradient of each
   term of the loss held card against CPU as each kernel is, at the
   weights of the card's first step (HAGCN) or of each of its steps
   (HierCorrPool, its ReLU masks replayed on the CPU), the forward and
   backward launches counted;
7. train, entry point: for each model, ``cli.main`` trains one epoch of a
   synthetic processed FD001 at the real size on the card, with the
   kernels' launches counted over that run alone; its results.csv and
   checkpoint.pt are read back, the checkpoint serves on the card as on
   the CPU, ``cli.main --eval_torch_checkpoint`` evaluates it on the card
   to the trainer's own final metrics (its launches counted), and
   ``python -m gnn_rul_tpu_torch.export``'s ``main`` exports it to an
   artifact that serves as the live model does;
8. times: CUDA-event medians of each kernel, its plain version and, for
   the LSTM recurrence, cuDNN's ``torch.nn.LSTM``, with the backward's time
   launch by launch (torch.profiler), HAGCN's shapes (T = 1,400 at H = 60
   and 120, T = 14,000 at 120) and its H = 120 at the B of each cluster
   size; the serving latency and
   samples/s (the two tier configurations too), the same requests through
   the symbolic-batch artifact and the live model in turns, the training
   step and epoch of each model, and torch.profiler breakdowns of one
   request and one training step.

The line before the last is one JSON object ``{"kernels": [...]}`` (five
entries); the last line is ``{"ok": true, "device": {...}}``.

``python3 -c "import chip_smoke as c; c._turns('build/parent')"`` times
the dot-graph forward and backward and the attention of an earlier commit
unpacked at ``build/parent`` and of this tree in turns on one card;
``c._turns('build/parent', c._HOST_TURN)`` the training steps and requests
of 100.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

from gnn_rul_tpu_torch import cli
from gnn_rul_tpu_torch.configs.data_configs import get_dataset_config
from gnn_rul_tpu_torch.configs.hparams import model_hparams, train_params
from gnn_rul_tpu_torch.data.io import save_processed
from gnn_rul_tpu_torch import export
from gnn_rul_tpu_torch.export import build_model, serving_model
from gnn_rul_tpu_torch.models import hagcn, stgnn
from gnn_rul_tpu_torch.models.stfa import prior_knowledge_graph
from gnn_rul_tpu_torch.nn import recurrent
from gnn_rul_tpu_torch.ops.graphs import covariance_threshold_graph
from gnn_rul_tpu_torch.ops.kernels import (WRAPPERS, build, fused_gat,
                                           fused_gnn, fused_lstm)
from gnn_rul_tpu_torch.ops.windows import decay_mask
from gnn_rul_tpu_torch.train.algorithms import get_algorithm_spec
from gnn_rul_tpu_torch.train.engine import Engine

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM fp32 outside the tensor cores
TOL_ATOL, TOL_RTOL = 1e-5, 1e-4          # kernel vs plain, both fp32
SERVE_ATOL, SERVE_RTOL = 2e-4, 1e-4      # card vs CPU, whole model
# artifact vs live model, both on the card: tests/test_export.py:52
ARTIFACT_ATOL, ARTIFACT_RTOL = 1e-5, 1e-5
SERVE_BATCH = 100                        # FD001 batch_size (hparams.py)
# card vs CPU over training steps: tests/test_parity_training.py:82-96
LOSS_RTOL, LOSS_ATOL, PARAM_MAX_DIFF = 2e-4, 2e-5, 5e-4
PARITY_STEPS = 5
# FD001 at its real size: 100 engines, 20,631 rows, windows of 50 at
# stride 1 -> 15,731 training windows; one test window per engine.
FD001_ENGINES, FD001_ROWS, WINDOW, MAX_RUL = 100, 20631, 50, 125
SMI = ""  # nvidia-smi's name and power limit, beside every time printed
LSTM_BWD_KERNELS = ("lstm_gates_kernel", "lstm_sweep_kernel",
                    "lstm_dw_partial_kernel", "lstm_dw_reduce_kernel")
OUR_KERNELS = ("fwd_graph_kernel", "fwd_rows_kernel", "bwd_graph_kernel",
               "bwd_rows_kernel", "bwd_cols_kernel", "lstm_fwd_kernel",
               *LSTM_BWD_KERNELS, "fused_gat_kernel")
# B at which the LSTM plans' thresholds in H are found (HAGCN's B = 5 plans
# as 3 does, widening every cluster to 8; at LOGO's 70 none widens), and H
# at which those in B are (HAGCN's 120, LOGO FD003's 192), B up to
# MAX_HIDDEN.
THRESHOLD_BS, THRESHOLD_HS = (3, 70), (120, 192)
# B at which the plan takes a cluster of 8, 4 and 2 CTAs at H = 120 on an
# H100's 132 SMs (fused_lstm.cuh, pick_plan), timed per step.
CLUSTER_BS = (5, 9, 17)
# The ported methods: the four of the kernels' slices, HAGCN (its Bi-LSTM on
# the recurrence kernels), then the seven that reach no port kernel.
METHODS = ("FC_STGNN", "LOGO", "STAGNN", "STFA", "HAGCN", "RGCNU", "GRU_CM",
           "STGNN", "DVGTformer", "HierCorrPool", "ASTGCNN", "ST_Conv")
# The benchmark tiers served at their own configurations (BASELINE.md tiers
# 3 and 4): (method, dataset, dataset_id).
TIERS = (("HierCorrPool", "CMAPSS", "FD004"), ("DVGTformer", "NCMAPSS", None))


class Path(NamedTuple):
    """A method's kernel wrapper, the registered operator that calls its
    forward kernel, and its launches: per model forward, per backward call
    (0 where the backward is the plain recompute, as for the graph
    attention), and per forward of a training step at the hparam bank's
    dropout. :data:`NO_KERNEL` for a method that reaches no port kernel."""
    kernel: object
    op: str
    per_forward: int
    bwd_per_call: int
    train_per_forward: int


_FC_HP = model_hparams("CMAPSS", "FD001", "FC_STGNN")
# The dot-graph chain's (N, D, F) at both of FC_STGNN's scales: the nodes of
# a time window of 2 (the model's default moving_window), D = F = twice the
# hidden width.
FC_STGNN_NDF = (2 * _FC_HP["num_node"], 2 * _FC_HP["hidden_dim"],
                2 * _FC_HP["hidden_dim"])
_STAGNN_HP = model_hparams("CMAPSS", "FD001", "STAGNN")
_STFA_HP = model_hparams("CMAPSS", "FD001", "STFA")
# The dot-graph chain runs once per scale, the LSTM recurrence once per
# Bi-LSTM layer, the graph attention once per head: STAGNN's two GAT layers
# of 3 heads, STFA's 10 heads. STFA's attention dropout (0.2) sends its
# training forwards down the plain path, so they launch none. The backward's
# launches per call come from the wrapper's mirror of its plan
# (fused_gnn.bwd_plan); the launches counted are those the C entry reports.
KERNEL_OF = {
    "FC_STGNN": Path(fused_gnn.fused_dot_graph_spmm, "fused_dot_graph_spmm",
                     2, fused_gnn.bwd_launches_per_call(*FC_STGNN_NDF), 2),
    "LOGO": Path(fused_lstm.lstm_recurrence, "lstm_recurrence", 3,
                 fused_lstm.BWD_LAUNCHES_PER_CALL, 3),
    "STAGNN": Path(fused_gat.fused_gat, "fused_gat",
                   2 * _STAGNN_HP["num_heads"], 0,
                   2 * _STAGNN_HP["num_heads"]),
    "STFA": Path(fused_gat.fused_gat, "fused_gat", _STFA_HP["num_heads"], 0,
                 0 if _STFA_HP["dropout"] > 0 else _STFA_HP["num_heads"]),
    # HAGCN's three Bi-LSTM layers (H = 60, 120, 60) at T = 14 x the batch
    # and B = num_patch = 5.
    "HAGCN": Path(fused_lstm.lstm_recurrence, "lstm_recurrence", 3,
                  fused_lstm.BWD_LAUNCHES_PER_CALL, 3),
}
NO_KERNEL = Path(None, None, 0, 0, 0)


def _path(method: str) -> Path:
    return KERNEL_OF.get(method, NO_KERNEL)


def _reset() -> None:
    """Every wrapper's counts to 0, before a main path is driven."""
    for kernel in WRAPPERS.values():
        kernel.launches = 0
        if hasattr(kernel, "bwd_launches"):
            kernel.bwd_launches = 0
        if hasattr(kernel, "bwd_calls"):
            kernel.bwd_calls = 0


def _counts(kernel):
    """(forward, backward) launches; a wrapper without a backward kernel
    counts none, and so does a method without a kernel (None)."""
    if kernel is None:
        return 0, 0
    return kernel.launches, getattr(kernel, "bwd_launches", 0)


def _only_its_kernel(method: str, what: str) -> None:
    """Fails where a wrapper other than ``method``'s kernel counted a launch
    since :func:`_reset`: every wrapper for a method without a kernel."""
    own = _path(method).kernel
    for kernel in WRAPPERS.values():
        if kernel is not own and _counts(kernel) != (0, 0):
            raise AssertionError(f"{what} {method}: {type(kernel).__name__} "
                                 f"launched {_counts(kernel)}, not its path")


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
    fused_lstm.lstm_recurrence.load()
    fused_gat.fused_gat.load()
    _print_graph_plans()
    for _, b, h in sorted(set(LSTM_CASES + _lstm_threshold_cases()),
                          key=lambda c: (c[2], c[1])):
        for name, backward in (("forward", False), ("backward sweep", True)):
            p = fused_lstm.lstm_recurrence.plan(h, b, backward)
            print(f"  lstm H={h} B={b} {name}: {p['lanes']} lanes a unit, "
                  f"cluster "
                  f"of {p['cluster']}, {p['threads']} threads a CTA, W_hh in "
                  f"{fused_lstm.W_MODES[p['w_mode']]}, {p['smem']} B of "
                  f"shared memory")


def _bwd_threshold(d: int, f: int) -> int:
    """The largest N at which the dot-graph backward runs in one launch at
    (D, F), by the wrapper's :func:`fused_gnn.bwd_plan`."""
    n = 1
    while fused_gnn.bwd_launches_per_call(n + 1, d, f) == 1:
        n += 1
    return n


# (D, F) at which the backward's and the forward's thresholds in N are
# found and checked: FC_STGNN's width and the kernels' limit on D and F.
THRESHOLD_DF = ((16, 16), (fused_gnn.MAX_FEAT, fused_gnn.MAX_FEAT))


def _fwd_threshold(d: int, f: int) -> int:
    """The largest N at which the dot-graph forward holds whole graphs in a
    block at (D, F), by the wrapper's :func:`fused_gnn.fwd_plan` (the
    threshold does not depend on B)."""
    n = 1
    while fused_gnn.fwd_plan(1, n + 1, d, f)["whole"]:
        n += 1
    return n


def _fwd_key(b: int, n: int, d: int, f: int):
    p = fused_gnn.fwd_plan(b, n, d, f)
    return p["whole"], p["graphs"], p["row_tiles"]


@functools.cache
def _fwd_threshold_cases():
    """(B, N, D, F) on each side of every point at which the forward's plan
    (whole graphs or the row-tile stream, graphs a block, row tiles a
    graph) changes: the whole-graph threshold in N at each (D, F) of
    THRESHOLD_DF, at B = 2 (rows tiled) and B = 132 (a whole graph a
    block, up to 232,448 B of shared memory); in B at FC_STGNN's (N, D, F)
    up to 1,400 (2 graphs a block from 264); in N at D = F = 16 at B = 1000
    (7 graphs a block down to 1) and at B = 3 (1 to 5 row tiles)."""
    cases = {(b, _fwd_threshold(d, f) + k, d, f) for d, f in THRESHOLD_DF
             for b in (2, 132) for k in (0, 1)}
    top = _fwd_threshold(16, 16) + 1
    for shape_of, hi in ((lambda v: (v, *FC_STGNN_NDF), 1400),
                         (lambda v: (1000, v, 16, 16), top),
                         (lambda v: (3, v, 16, 16), top)):
        keys = [_fwd_key(*shape_of(v)) for v in range(1, hi + 1)]
        cases.update(shape_of(u) for v in range(2, hi + 1)
                     if keys[v - 1] != keys[v - 2] for u in (v - 1, v))
    return sorted(cases)


@functools.cache
def _bwd_threshold_cases():
    """(2, N, D, F) on each side of the point at which the backward goes
    from one launch to two, at each (D, F) of THRESHOLD_DF."""
    return [(2, _bwd_threshold(d, f) + k, d, f) for d, f in THRESHOLD_DF
            for k in (0, 1)]


def _gat_key(b: int, n: int, d: int):
    p = fused_gat.gat_plan(b, n, d)
    return p["graphs"], p["row_tiles"], p["cols"] == d


@functools.cache
def _gat_threshold_cases():
    """(B, N, D, per-graph adj, bias, slope) on each side of every point at
    which the attention kernel's plan (graphs a block, blocks a graph, wh
    in chunks or whole) changes: in B at STFA's (N, D) = (14, 5) up to
    B = 1,400 (10 graphs a block from B = 1,320) and at STAGNN's (14, 64) up
    to B = 700 (2 graphs a block from B = 264), in N at B = 140 and D = 16 up to N = 160 (past where a whole graph stops
    fitting the block), in D at B = 1 and N = 41 up to D = 400 (past where
    wh goes in chunks)."""
    cases = set()
    for shape_of, top, batched in (
            (lambda v: (v, 14, 5), 1400, False),
            (lambda v: (v, 14, 64), 700, True),
            (lambda v: (140, v, 16), 160, True),
            (lambda v: (1, 41, v), 400, False)):
        keys = [_gat_key(*shape_of(v)) for v in range(1, top + 1)]
        for v in range(2, top + 1):
            if keys[v - 1] != keys[v - 2]:
                cases.update((*shape_of(u), batched, 0.3, 0.1)
                             for u in (v - 1, v))
    return sorted(cases)


def _print_graph_plans() -> None:
    """Prints the dot-graph forward's and backward's and the attention's
    plans as the built libraries choose them, and fails where the wrappers'
    plans (which size the scratch and count the launches) disagree."""
    kernel = fused_gnn.fused_dot_graph_spmm
    fwd_cases = KERNEL_CASES + _fwd_threshold_cases()
    for d, f in THRESHOLD_DF:
        top = _fwd_threshold(d, f)
        fwd_cases += [(b, n, d, f) for b in (1, 132, 1000)
                      for n in range(1, top + 2)]
    for case in fwd_cases:
        if kernel.kernel_fwd_plan(*case) != fused_gnn.fwd_plan(*case):
            raise AssertionError(f"forward plan at (B, N, D, F)={case}: "
                                 f"{kernel.kernel_fwd_plan(*case)} built, "
                                 f"{fused_gnn.fwd_plan(*case)} wrapper")
    for case in KERNEL_CASES:
        print(f"  dot-graph forward (B, N, D, F)={case}: "
              f"{kernel.kernel_fwd_plan(*case)}")
    for d, f in THRESHOLD_DF:
        top = _fwd_threshold(d, f)
        print(f"  dot-graph forward D={d} F={f}: whole graphs up to N={top} "
              f"({kernel.kernel_fwd_plan(132, top, d, f)['smem']} B of "
              f"shared memory at B=132), the row-tile stream from "
              f"N={top + 1}")
    print(f"  dot-graph forward: {len(fwd_cases)} plans as the wrapper's, "
          f"{len(_fwd_threshold_cases())} threshold cases")
    for d, f in THRESHOLD_DF:
        top = _bwd_threshold(d, f)
        for n in range(1, top + 2):
            if kernel.kernel_plan(n, d, f) != fused_gnn.bwd_plan(n, d, f):
                raise AssertionError(f"backward plan at N={n} D={d} F={f}: "
                                     f"{kernel.kernel_plan(n, d, f)} built, "
                                     f"{fused_gnn.bwd_plan(n, d, f)} wrapper")
        print(f"  dot-graph backward D={d} F={f}: one launch (a block of 256 "
              f"threads per graph) up to N={top} "
              f"({kernel.kernel_plan(top, d, f)['smem']} B of shared memory "
              f"there), the row and column pass (two launches) from "
              f"N={top + 1}")
    n, d, f = FC_STGNN_NDF
    print(f"  dot-graph backward at FC_STGNN's N={n} D={d} F={f}: "
          f"{kernel.kernel_plan(n, d, f)}")
    attn = fused_gat.fused_gat
    for b, n, d, *_ in GAT_CASES + _gat_threshold_cases():
        got = attn.kernel_plan(b, n, d)
        if got != fused_gat.gat_plan(b, n, d):
            raise AssertionError(f"attention plan at B={b} N={n} D={d}: "
                                 f"{got} built, {fused_gat.gat_plan(b, n, d)}"
                                 f" wrapper")
    for b, n, d, *_ in GAT_CASES:
        print(f"  attention B={b} N={n} D={d}: {attn.kernel_plan(b, n, d)}")
    print(f"  attention: {len(_gat_threshold_cases())} threshold cases, "
          f"plans as the wrapper's")


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
    """The forward kernels against the fp32 plain version at every case and
    on each side of every point where the plan changes; each call must
    report one launch."""
    kernel = fused_gnn.fused_dot_graph_spmm
    worst = 0.0
    for i, (b, n, d, f) in enumerate(KERNEL_CASES + _fwd_threshold_cases()):
        h, x, mask = _fused_inputs(b, n, d, f, seed=i)
        before = kernel.launches
        got = kernel(h, x, mask)
        launches = kernel.launches - before
        want = fused_gnn.fused_dot_graph_spmm_plain(h, x, mask)
        torch.cuda.synchronize()
        err = (got - want).abs()
        max_err = err.max().item()
        ok = bool((err <= TOL_ATOL + TOL_RTOL * want.abs()).all())
        plan = "whole graphs" if fused_gnn.fwd_plan(b, n, d, f)["whole"] \
            else "row-tile stream"
        print(f"kernel vs plain B={b} N={n} D={d} F={f} ({plan}): "
              f"max_abs_err={max_err:.3e} {'ok' if ok else 'FAIL'}")
        if launches != 1:
            raise AssertionError(f"the forward at B={b} N={n} D={d} F={f} "
                                 f"reported {launches} launches, not 1")
        if not ok or not torch.isfinite(got).all():
            raise AssertionError(f"fused_dot_graph_spmm disagrees with its "
                                 f"plain version at B={b} N={n} D={d} F={f}")
        worst = max(worst, max_err)
    return worst


def _hold(what: str, got, want, exact) -> float:
    """``got`` against the fp32 plain ``want`` at TOL; a component that
    misses is held against ``exact()``, the plain version in fp64 on the
    card, at the same tolerance (PR 2's rule: it passes only if the kernel
    is the closer of the two to the exact function). Returns the error."""
    err = (got - want).abs()
    ok = bool((err <= TOL_ATOL + TOL_RTOL * want.abs()).all())
    ref = "fp32 plain"
    if not ok:
        p64 = exact()
        ref = (f"fp64 plain (fp32 plain off by "
               f"{(want.double() - p64).abs().max().item():.3e})")
        err = (got.double() - p64).abs()
        ok = bool((err <= TOL_ATOL + TOL_RTOL * p64.abs()).all())
    max_err = err.max().item()
    print(f"{what}: max_abs_err={max_err:.3e} against the {ref} "
          f"{'ok' if ok else 'FAIL'}")
    if not ok or not torch.isfinite(got).all():
        raise AssertionError(f"{what} disagrees with its plain version")
    return max_err


def _bwd_vs_plain() -> float:
    """The backward kernels against the plain backward at every case and on
    each side of the one-launch threshold, dmask included, by
    :func:`_hold`: where dS = P (dP - inner) cancels, the fp32 plain
    version's own rounding can exceed the tolerance."""
    kernel = fused_gnn.fused_dot_graph_spmm
    plain = fused_gnn.fused_dot_graph_spmm_bwd_plain
    worst = 0.0
    for i, (b, n, d, f) in enumerate(KERNEL_CASES + _bwd_threshold_cases()):
        h, x, mask = _fused_inputs(b, n, d, f, seed=i)
        g = torch.randn(x.shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(100 + i))
        before = kernel.bwd_launches
        dh, dx, dmask = kernel.backward(h, x, mask, g, need_dmask=True)
        launches = kernel.bwd_launches - before
        if launches != fused_gnn.bwd_launches_per_call(n, d, f):
            raise AssertionError(f"the backward at N={n} D={d} F={f} "
                                 f"launched {launches} kernels, its plan "
                                 f"{fused_gnn.bwd_plan(n, d, f)}")
        got = (dh, dx, dmask.sum(dim=0))
        pdh, pdx, pdmask = plain(h, x, mask, g)
        want = (pdh, pdx, pdmask.sum(dim=0))
        torch.cuda.synchronize()

        @functools.cache
        def exact():
            e = plain(*(t.double() for t in (h, x, mask, g)))
            return e[0], e[1], e[2].sum(dim=0)

        for k, name in enumerate(("dh", "dx", "dmask")):
            worst = max(worst, _hold(
                f"backward vs plain B={b} N={n} D={d} F={f} ({launches} "
                f"launch{'es' if launches > 1 else ''}) {name}", got[k],
                want[k], lambda k=k: exact()[k]))
    return worst


# (T, B, H) of the LSTM recurrence: LOGO training (T = the batch of 100,
# B = 70 node-patches, H = 24 and 48), the epoch's remainder batch, the
# symbolic serving batch of 1000, HAGCN (T = 1400 at B = 5, H = 60, 120),
# W_hh beyond one CTA's shared memory (H = 192), the LOGO_bearing/XJTU trunk
# layer (T = 100, B = 544, H = 30), ragged shapes, the H limit (1024).
LSTM_CASES = [(100, 70, 24), (100, 70, 48), (31, 70, 24), (1000, 70, 48),
              (1400, 5, 60), (1400, 5, 120), (100, 70, 192), (100, 544, 30),
              (7, 13, 30), (1, 1, 8), (5, 3, 1024)]


@functools.cache
def _lstm_threshold_cases():
    """(6, B, H) on each side of every point at which the forward's or the
    backward sweep's plan (lanes per unit, cluster size, where W_hh sits,
    rows per lane) changes on this card: one H on each side at each B of
    THRESHOLD_BS, one B on each side at each H of THRESHOLD_HS."""
    kernel = fused_lstm.lstm_recurrence

    def key(h, b):
        plans = (kernel.plan(h, b, backward) for backward in (False, True))
        return tuple((p["lanes"], p["cluster"], p["w_mode"],
                      p["iters"] if p["w_mode"] == 2 else 0) for p in plans)

    top = fused_lstm.MAX_HIDDEN
    cases = set()
    for b in THRESHOLD_BS:
        keys = [key(h, b) for h in range(1, top + 1)]
        cases.update((6, b, h + d) for h in range(2, top + 1)
                     if keys[h - 1] != keys[h - 2] for d in (-1, 0))
    for h in THRESHOLD_HS:
        keys = [key(h, b) for b in range(1, top + 1)]
        cases.update((6, b + d, h) for b in range(2, top + 1)
                     if keys[b - 1] != keys[b - 2] for d in (-1, 0))
    return sorted(cases, key=lambda c: (c[2], c[1]))


def _lstm_inputs(t: int, b: int, h: int, seed: int):
    """Seeded recurrence inputs on the card: unit-normal gate inputs, W_hh
    from nn.LSTM's U(-1/sqrt(H), 1/sqrt(H)), unit-normal cotangents of ys
    and c_fin."""
    rng = np.random.default_rng(seed)
    arrays = (rng.normal(size=(t, 2, b, 4 * h)),
              rng.uniform(-1, 1, size=(2, h, 4 * h)) / np.sqrt(h),
              rng.normal(size=(t, 2, b, h)), rng.normal(size=(2, b, h)))
    return tuple(torch.as_tensor(a, dtype=torch.float32).cuda().contiguous()
                 for a in arrays)


def _lstm_case_vs_plain(t: int, b: int, h: int, seed: int):
    """The recurrence kernels against their plain versions at one (T, B, H):
    the forward's ys, c trajectory and c_fin; the gate pass's activated
    gates and the backward's dxg and dw_hh, on the kernel's saved
    trajectories, with nonzero cotangents of both outputs. Returns the
    largest (forward, backward) errors."""
    kernel = fused_lstm.lstm_recurrence
    xg, w, dys, dcf = _lstm_inputs(t, b, h, seed)
    ys, cs, c_fin = kernel.forward(xg, w)
    p_ys, p_cs = fused_lstm.lstm_trajectory_plain(xg, w)
    torch.cuda.synchronize()
    fwd64 = functools.cache(lambda: fused_lstm.lstm_trajectory_plain(
        xg.double(), w.double()))
    plan = kernel.plan(h, b)
    shape = f"T={t} B={b} H={h}" + (f" (cluster of {plan['cluster']})"
                                    if plan["cluster"] > 1 else "")
    worst_fwd = worst_bwd = 0.0
    for name, got, want, exact in (
            ("ys", ys, p_ys, lambda: fwd64()[0]),
            ("cs", cs, p_cs, lambda: fwd64()[1]),
            ("c_fin", c_fin, p_cs[-1], lambda: fwd64()[1][-1])):
        worst_fwd = max(worst_fwd, _hold(
            f"lstm forward vs plain {shape} {name}", got, want, exact))

    gates = kernel.gates(xg, w, ys)
    want_gates = fused_lstm.lstm_gates_plain(xg, w, ys)
    dxg, dw = kernel.backward(xg, w, ys, cs, dys, dcf)
    want = fused_lstm.lstm_recurrence_bwd_plain(xg, w, ys, cs, dys, dcf)
    torch.cuda.synchronize()
    worst_bwd = max(worst_bwd, _hold(
        f"lstm backward gate pass vs plain {shape} gates", gates, want_gates,
        lambda: fused_lstm.lstm_gates_plain(xg.double(), w.double(),
                                            ys.double())))
    bwd64 = functools.cache(lambda: fused_lstm.lstm_recurrence_bwd_plain(
        *(a.double() for a in (xg, w, ys, cs, dys, dcf))))
    for k, (name, got) in enumerate((("dxg", dxg), ("dw", dw))):
        worst_bwd = max(worst_bwd, _hold(
            f"lstm backward vs plain {shape} {name}", got, want[k],
            lambda k=k: bwd64()[k]))
    return worst_fwd, worst_bwd


def _lstm_vs_plain():
    """:func:`_lstm_case_vs_plain` at LSTM_CASES and at the plans' threshold
    cases. Returns the largest (forward, backward) errors."""
    worst = [0.0, 0.0]
    for i, (t, b, h) in enumerate(LSTM_CASES + _lstm_threshold_cases()):
        errs = _lstm_case_vs_plain(t, b, h, 200 + i)
        worst = [max(a, e) for a, e in zip(worst, errs)]
    return tuple(worst)


# (B, N, D, per-graph adj, bias, slope) of the graph attention: STAGNN's
# serving shapes (per-graph covariance graphs), STFA's (B x 25 patch graphs
# on the shared prior graph: 2500 at batch 100, 25,000 for a request of
# 1000), GDAGDL's N = 17 at GAT_LSTM's D = 300, ragged shapes, a negative
# bias at slope 0.01, and a negative slope (the kernel takes each row's max
# over its logits, not through f2's).
GAT_CASES = [(100, 14, 64, True, 0.3, 0.1), (1000, 14, 64, True, 0.3, 0.1),
             (2500, 14, 5, False, 0.3, 0.1), (25000, 14, 5, False, 0.3, 0.1),
             (3, 17, 300, True, 0.3, 0.1), (1, 1, 1, True, 0.3, 0.1),
             (5, 33, 7, False, 0.3, 0.1), (2, 130, 16, True, 0.3, 0.1),
             (7, 33, 40, True, -0.4, 0.01), (300, 14, 64, True, 0.2, -0.3)]


def _gat_inputs(b: int, n: int, d: int, batched: bool, bias: float,
                seed: int):
    """Seeded attention inputs on the card: unit-normal wh, f1 and f2
    (logits of unit scale, as a Linear projection gives), a random 0/1
    per-graph adjacency with its diagonal set (a covariance graph's
    variances), or STFA's prior graph where the shared one is 14 x 14."""
    rng = np.random.default_rng(seed)
    wh = rng.normal(size=(b, n, d))
    f1 = rng.normal(size=(b, n))
    f2 = rng.normal(size=(b, n))
    if batched:
        adj = (rng.uniform(size=(b, n, n)) > 0.5).astype(np.float64)
        adj[:, np.arange(n), np.arange(n)] = 1.0
    elif n == 14:
        adj = prior_knowledge_graph().numpy()
    else:
        adj = (rng.uniform(size=(n, n)) > 0.5).astype(np.float64)
    return tuple(torch.as_tensor(t, dtype=torch.float32).cuda().contiguous()
                 for t in (wh, f1, f2, adj, np.float64(bias)))


def _gat_vs_plain() -> float:
    """The attention kernel against its plain version at GAT_CASES and on
    each side of its plan thresholds, by :func:`_hold`."""
    kernel = fused_gat.fused_gat
    worst = 0.0
    for i, (b, n, d, batched, bias, slope) in enumerate(
            GAT_CASES + _gat_threshold_cases()):
        args = _gat_inputs(b, n, d, batched, bias, seed=300 + i)
        got = kernel(*args, slope)
        want = fused_gat.fused_gat_plain(*args, slope)
        torch.cuda.synchronize()
        worst = max(worst, _hold(
            f"gat vs plain B={b} N={n} D={d} "
            f"adj={'per-graph' if batched else 'shared'} bias={bias} "
            f"slope={slope}", got, want,
            lambda: fused_gat.fused_gat_plain(
                *(t.double() for t in args), slope)))
    return worst


def _adjacency_margin(what: str, x: np.ndarray) -> int:
    """STAGNN's adjacency is ``cov > threshold``, a step function. Prints
    the smallest nonzero |cov - threshold| over the windows ``x`` (fp64 on
    the host; a constant row gives an exact 0 on every device) and the
    number of adjacency entries on which the card's graph and the CPU's
    differ. A differing entry is reported, and the answers are still held
    at the same tolerance. Returns the count."""
    threshold = _STAGNN_HP["threshold"]
    x64 = torch.from_numpy(x).double()
    xc = x64 - x64.mean(dim=-1, keepdim=True)
    cov = torch.einsum("...nl,...ml->...nm", xc, xc) / (x.shape[-1] - 1)
    gap = (cov - threshold).abs()
    card = covariance_threshold_graph(torch.from_numpy(x).cuda(), threshold)
    cpu = covariance_threshold_graph(torch.from_numpy(x), threshold)
    differ = int((card.cpu() != cpu).sum())
    print(f"adjacency STAGNN {what}: {len(x)} windows, smallest nonzero "
          f"|cov - {threshold}| {gap[gap > 0].min().item():.3e} (fp64), "
          f"{int((gap == 0).sum())} entries exactly at it; {differ} of "
          f"{cpu.numel()} entries differ between card and CPU")
    return differ


@contextlib.contextmanager
def _plain_recurrence():
    """The models' Bi-LSTM recurrence on its plain version, differentiable
    by autograd at any dtype, for an fp64 reference run (the registered
    operator takes fp32 only)."""
    kept = recurrent.lstm_recurrence
    recurrent.lstm_recurrence = fused_lstm.lstm_recurrence_plain
    try:
        yield
    finally:
        recurrent.lstm_recurrence = kept


# The methods whose forward selects by top-k, and the function it selects
# with: HAGCN's SAGPool keeps a graph's k = 10, 5 and 1 nodes of highest
# score (the indices), STGNN keeps each row's top_k gaussian similarities
# (a 0/1 mask).
RANKED = {"HAGCN": (hagcn, "top_indices"), "STGNN": (stgnn, "topk_mask")}


# The methods whose held gradients (GRADIENT_HELD) are taken with the
# card's ReLU masks replayed on the CPU (:class:`_Kinks`): HierCorrPool's
# encoder ReLUs follow train-mode BatchNorms, whose outputs cross 0 within
# the card's rounding (on an H100 80GB HBM3 at 700 W, one input to its
# third block's ReLU, 1.1e-7 from 0, took the other side on the card,
# which moved the conv3 weight gradient by 1.8e-5, above TOL). Over the 5
# free-running steps the masks are each side's own: the steps part the
# weights by up to the learning rate (GRADIENT_HELD), and the masks with
# them (by step 5 an input 4.8e-3 from 0 took another side).
KINKED = ("HierCorrPool",)


def _during(sel, mode: str):
    """``sel.record()`` or ``sel.replay()``; nothing for a method that
    replays no step function (``sel`` None)."""
    return getattr(sel, mode)() if sel else contextlib.nullcontext()


class _Kinks:
    """The masks ``x > 0`` of every ``nn.ReLU`` of a kinked method's
    forwards: recorded as the card makes them, then replayed in the same
    order on the CPU (and in fp64) as ``x * mask``, so that both sides
    differentiate the same function. ReLU's gradient is a step function of
    its input: where an input lies within rounding of 0, the card and the
    CPU may pass or stop that element's whole gradient. :meth:`report`
    counts the entries whose mask differs and fails where such an input
    lies further than TOL_ATOL from 0 on the CPU."""

    def __init__(self):
        self.card = []   # the card's masks on the host, per ReLU call
        self.cpu = []    # (the CPU's input, its own mask)

    @contextlib.contextmanager
    def _patched(self, fn):
        forward = torch.nn.ReLU.forward
        torch.nn.ReLU.forward = fn
        try:
            yield
        finally:
            torch.nn.ReLU.forward = forward

    def record(self):
        def fn(module, x):
            self.card.append((x > 0).cpu())
            return torch.relu(x)
        return self._patched(fn)

    def replay(self):
        """Replays the card's masks from the first; keeps the CPU's own of
        the first replay."""
        it = iter(self.card)
        first = not self.cpu

        def fn(module, x):
            mask = next(it)
            if mask.shape != x.shape:
                raise AssertionError("the CPU's forwards are not the card's")
            if first:
                self.cpu.append((x.detach().cpu(), (x > 0).cpu()))
            return x * mask.to(x.device, x.dtype)
        return self._patched(fn)

    def report(self, method: str, what: str) -> int:
        """Prints the ReLU inputs whose mask differs between card and CPU
        and the largest |input| among them; returns their count."""
        if len(self.card) != len(self.cpu):
            raise AssertionError(f"{len(self.card)} ReLU calls on the card, "
                                 f"{len(self.cpu)} replayed")
        entries = differ = 0
        far = 0.0
        for (x, own), card in zip(self.cpu, self.card):
            flipped = own != card
            entries += own.numel()
            differ += int(flipped.sum())
            if flipped.any():
                far = max(far, x[flipped].abs().max().item())
        print(f"relu {method} {what}: {entries} inputs, {differ} masks differ "
              f"between card and CPU"
              + (f", the largest |input| among them {far:.3e}" if differ
                 else "") + "; the CPU replays the card's masks")
        if far > TOL_ATOL:
            raise AssertionError(f"{method}: a ReLU input {far} from 0 takes "
                                 f"another side on the card")
        return differ


class _Selections:
    """The top-k selections of a ranked method's forwards: recorded as the
    card makes them, then replayed in the same order on the CPU (and in
    fp64), so that both sides compute the same function. A selection is a
    step function of its scores: where two scores lie within rounding, the
    card and the CPU may pick other nodes and give answers that differ by
    more than any tolerance. Each replayed forward also keeps the CPU's own
    selection from its own scores; :meth:`report` counts where the two
    differ and fails where a node kept by one and not by the other scores
    further than the kernels' relative tolerance from its row's k-th."""

    def __init__(self, method: str):
        self.module, self.name = RANKED[method]
        self.select = getattr(self.module, self.name)
        self.card = []   # (k, scores, selection) on the host, per forward
        self.cpu = []    # (k, scores, the CPU's own selection)

    @contextlib.contextmanager
    def _patched(self, fn):
        setattr(self.module, self.name, fn)
        try:
            yield
        finally:
            setattr(self.module, self.name, self.select)

    def record(self):
        def fn(scores, k):
            chosen = self.select(scores, k)
            self.card.append((k, scores.detach().cpu(), chosen.cpu()))
            return chosen
        return self._patched(fn)

    def replay(self):
        """Replays the card's selections from the first; keeps the CPU's
        own of the first replay."""
        it = iter(self.card)
        first = not self.cpu

        def fn(scores, k):
            k_card, card_scores, chosen = next(it)
            if k_card != k or card_scores.shape != scores.shape:
                raise AssertionError("the CPU's forwards are not the card's")
            if first:
                self.cpu.append((k, scores.detach().cpu(),
                                 self.select(scores, k).cpu()))
            return chosen.to(scores.device, (scores.dtype if chosen
                                             .is_floating_point()
                                             else chosen.dtype))
        return self._patched(fn)

    def report(self, method: str, what: str) -> int:
        """Prints the smallest gap between the k-th and (k+1)-th score of
        every row ranked on the CPU and the selections that differ between
        card and CPU (graphs whose kept nodes differ, or mask entries);
        returns their count. Fails where a node kept on one side and not
        on the other (or a mask entry that differs) scores, on the CPU,
        further than the kernels' relative tolerance from its row's k-th
        score."""
        if len(self.card) != len(self.cpu):
            raise AssertionError(f"{len(self.card)} selections on the card, "
                                 f"{len(self.cpu)} replayed")
        rows = ties = differ = 0
        gap_min = rel_min = float("inf")
        rel_differ = 0.0
        for (k, scores, own), (_, _, chosen) in zip(self.cpu, self.card):
            # Every k here is below the row length N (k = 10, 5, 1 of 14,
            # 10, 5 nodes; 10 of 14).
            scores = scores.double().reshape(-1, scores.shape[-1])
            if own.dtype == torch.long:       # indices: compare as sets
                kept = [torch.zeros(scores.shape, dtype=torch.bool).scatter(
                    1, c.reshape(-1, k), True) for c in (own, chosen)]
                swapped = kept[0] ^ kept[1]
                differ += int(swapped.any(-1).sum())
            else:                             # masks: count entries
                swapped = (own != chosen).reshape(scores.shape)
                differ += int(swapped.sum())
            rows += scores.shape[0]
            top = scores.sort(-1, descending=True).values
            gap = top[:, k - 1] - top[:, k]
            rel = gap / top[:, k - 1].abs().clamp(min=1e-300)
            ties += int((gap == 0).sum())
            if (gap > 0).any():
                gap_min = min(gap_min, gap[gap > 0].min().item())
                rel_min = min(rel_min, rel[gap > 0].min().item())
            if swapped.any():
                kth = top[:, k - 1:k]
                far = (scores - kth).abs() / kth.abs().clamp(min=1e-300)
                rel_differ = max(rel_differ, far[swapped].max().item())
        print(f"top-k {method} {what}: {rows} rows ranked, smallest nonzero "
              f"gap between the k-th and (k+1)-th score {gap_min:.3e} "
              f"(relative {rel_min:.3e}), {ties} rows tied exactly there; "
              f"{differ} selections differ between card and CPU"
              + (f", the score of a node kept on one side only at most "
                 f"{rel_differ:.3e} relative from its row's k-th"
                 if differ else "")
              + "; the CPU replays the card's selections")
        if differ and rel_differ > TOL_RTOL:
            raise AssertionError(f"{method}: a node kept on one side only "
                                 f"scores {rel_differ} relative from its "
                                 f"row's k-th, above {TOL_RTOL}")
        return differ


def _seeded_state_dict(method: str = "FC_STGNN", seed: int = 0,
                       dataset: str = "CMAPSS", dataset_id="FD001"):
    """``method`` weights at ``(dataset, dataset_id)`` from ``seed``, with
    any BN running statistics set away from (0, 1) so that eval-mode BN is
    not the identity."""
    torch.manual_seed(seed)
    sd = build_model(method, dataset, dataset_id).state_dict()
    gen = torch.Generator().manual_seed(seed)
    for k, v in sd.items():
        if k.endswith("running_mean"):
            v.copy_(torch.randn(v.shape, generator=gen) * 0.5)
        elif k.endswith("running_var"):
            v.copy_(torch.rand(v.shape, generator=gen) * 1.5 + 0.5)
    return sd


def _serve(method: str):
    """Drive ``method``'s serving path; return the models, a request of each
    size and the kernel's launches over the run. Each answer is held
    against the CPU at the same batch: LOGO's answers depend on the other
    rows of a forward, the padding rows included."""
    sd = _seeded_state_dict(method)
    models = {bs: {dev: serving_model(method, "CMAPSS", "FD001", sd,
                                      batch_size=bs, device=dev)
                   for dev in ("cuda", "cpu")}
              for bs in (SERVE_BATCH, None)}
    rng = np.random.default_rng(1)
    requests = [(SERVE_BATCH, rng.normal(size=(n, 14, 50)).astype(np.float32))
                for n in [SERVE_BATCH] * 5 + [37]]
    requests.append((None, rng.normal(size=(1000, 14, 50))
                     .astype(np.float32)))
    forwards = sum(-(-len(x) // (bs or len(x))) for bs, x in requests)

    sel = _Selections(method) if method in RANKED else None
    path = _path(method)
    _reset()
    with _during(sel, "record"):
        answers = [models[bs]["cuda"](x) for bs, x in requests]
    torch.cuda.synchronize()
    launches = _counts(path.kernel)[0]
    _only_its_kernel(method, "serve")

    if method == "STAGNN":
        _adjacency_margin("serving requests",
                          np.concatenate([x for _, x in requests]))
    with _during(sel, "replay"):
        wants = [models[bs]["cpu"](x) for bs, x in requests]
    if sel:
        sel.report(method, "serving requests")
    for (bs, x), got, want in zip(requests, answers, wants):
        if got.shape != (len(x),) or not np.isfinite(got).all():
            raise AssertionError(f"serving answer of shape {got.shape} for "
                                 f"{len(x)} rows, or not finite")
        np.testing.assert_allclose(got, want, atol=SERVE_ATOL,
                                   rtol=SERVE_RTOL)
    name = type(path.kernel).__name__ if path.kernel else "no port kernel,"
    print(f"serve {method}: {len(requests)} requests, {forwards} forwards, "
          f"{name} launches={launches}; every answer matches the CPU "
          f"(atol={SERVE_ATOL}, rtol={SERVE_RTOL})")
    if launches != path.per_forward * forwards:
        raise AssertionError(f"expected {path.per_forward} launches per "
                             f"forward, got {launches} for {forwards}")
    return (models[SERVE_BATCH]["cuda"], models[None]["cuda"],
            requests[0][1], requests[-1][1], launches, requests, sd)


def _serve_tiers():
    """The tier configurations' serving path: each of TIERS at its own
    hparams with seeded weights, a request of 100 through a fixed batch of
    100 and one of 1000 through a symbolic batch, every answer on the card
    against the CPU at the same batch; no wrapper may count a launch.
    Returns {"<method> <dataset>/<dataset_id>": (fixed, symbolic, x100,
    x1000)}."""
    out = {}
    for method, dataset, dataset_id in TIERS:
        sd = _seeded_state_dict(method, 0, dataset, dataset_id)
        channels = get_dataset_config(dataset).input_channels
        models = {bs: {dev: serving_model(method, dataset, dataset_id, sd,
                                          batch_size=bs, device=dev)
                       for dev in ("cuda", "cpu")}
                  for bs in (SERVE_BATCH, None)}
        rng = np.random.default_rng(4)
        requests = [(bs, rng.normal(size=(n, channels, WINDOW))
                     .astype(np.float32))
                    for bs, n in ((SERVE_BATCH, SERVE_BATCH), (None, 1000))]
        _reset()
        answers = [models[bs]["cuda"](x) for bs, x in requests]
        torch.cuda.synchronize()
        _only_its_kernel(method, f"serve {dataset}/{dataset_id}")
        worst = 0.0
        for (bs, x), got in zip(requests, answers):
            want = models[bs]["cpu"](x)
            if got.shape != (len(x),) or not np.isfinite(got).all():
                raise AssertionError(f"serving answer of shape {got.shape} "
                                     f"for {len(x)} rows, or not finite")
            np.testing.assert_allclose(got, want, atol=SERVE_ATOL,
                                       rtol=SERVE_RTOL)
            worst = max(worst, float(np.abs(got - want).max()))
        print(f"serve {method} {dataset}/{dataset_id}: requests of "
              f"{SERVE_BATCH} and 1000 of ({channels}, {WINDOW}) windows, "
              f"no port kernel launched; every answer matches the CPU, max "
              f"|diff| {worst:.3e} (atol={SERVE_ATOL}, rtol={SERVE_RTOL})")
        out[f"{method} {dataset}/{dataset_id}"] = (
            models[SERVE_BATCH]["cuda"], models[None]["cuda"],
            requests[0][1], requests[1][1])
    return out


def _op_nodes(program) -> dict:
    """{op: calls of the registered operator ``gnn_rul_tpu_torch::<op>``}
    in an exported program's graph, for each of the port's operators."""
    return {op: sum(n.op == "call_function" and n.target is getattr(
        torch.ops.gnn_rul_tpu_torch, op).default for n in program.graph.nodes)
            for op in WRAPPERS}


def _artifacts(method: str, served, tmp: str):
    """The main path of serving artifacts: ``method`` exported for the card
    at a symbolic batch and at batch 100 and for the CPU at a symbolic
    batch, each saved and loaded on the card; ``_serve``'s requests served
    through each (the 1000-row one through the symbolic ones), every answer
    held against the live model on the card at the same batch, and each
    artifact's launches counted over its own requests. Returns the
    symbolic artifact exported for the card and the launches of all
    three."""
    fixed, symbolic, _, _, _, requests, sd = served
    path = _path(method)
    total = 0
    arts = {}
    for label, bs, dev in (("for cuda, symbolic batch", None, "cuda"),
                           (f"for cuda, batch {SERVE_BATCH}", SERVE_BATCH,
                            "cuda"),
                           ("for cpu, symbolic batch, moved at load", None,
                            "cpu")):
        t0 = time.perf_counter()
        meta, program = export.export_serving(method, "CMAPSS", "FD001", sd,
                                              batch_size=bs, device=dev)
        counted = _op_nodes(program)
        nodes = counted.get(path.op, 0)
        art_path = export.save_artifact(
            os.path.join(tmp, f"{method}_{len(arts)}.pt2"), meta, program)
        art = export.load_artifact(art_path, device="cuda")
        arts[label] = art
        print(f"artifact {method} ({label}): exported in "
              f"{time.perf_counter() - t0:.2f} s, "
              f"{os.path.getsize(art_path)} bytes, operator nodes in the "
              f"graph {counted}")
        if counted != {op: path.per_forward if op == path.op else 0
                       for op in WRAPPERS}:
            raise AssertionError(f"expected {path.per_forward} "
                                 f"{path.op} operator nodes, found {counted}")
        live = symbolic if bs is None else fixed
        # The fixed-batch artifact takes the requests of phase 4's fixed
        # batch; the symbolic ones take the 1000-row request too.
        xs = [x for rbs, x in requests if bs is None or rbs == bs]
        forwards = sum(-(-len(x) // (bs or len(x))) for x in xs)
        _reset()
        answers = [art(x) for x in xs]
        torch.cuda.synchronize()
        launches = _counts(path.kernel)[0]
        _only_its_kernel(method, "artifact")
        worst = 0.0
        for x, got in zip(xs, answers):
            want = live(x)
            if got.shape != (len(x),) or not np.isfinite(got).all():
                raise AssertionError(f"artifact answer of shape {got.shape} "
                                     f"for {len(x)} rows, or not finite")
            np.testing.assert_allclose(got, want, atol=ARTIFACT_ATOL,
                                       rtol=ARTIFACT_RTOL)
            worst = max(worst, float(np.abs(got - want).max()))
        print(f"artifact {method} ({label}): {len(xs)} requests "
              f"({sum(map(len, xs))} rows), {forwards} forwards, "
              f"{type(path.kernel).__name__ if path.kernel else 'no kernel,'}"
              f" launches={launches}; every "
              f"answer matches the live model on the card, max |diff| "
              f"{worst:.3e} (atol={ARTIFACT_ATOL}, rtol={ARTIFACT_RTOL})")
        if launches != path.per_forward * forwards:
            raise AssertionError(f"expected {path.per_forward} launches per "
                                 f"forward, got {launches} for {forwards}")
        total += launches
    return arts["for cuda, symbolic batch"], total


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


# Methods whose 5-step parameters no fp32 run need hold within
# PARAM_MAX_DIFF of the same steps in fp64: HAGCN's alpha = 100 weights a
# KL whose gradients cancel to rounding in places (its scores start near
# the prior), and Adam's normalised step moves such a weight by up to the
# learning rate whatever the gradient's size (this phase at batch 100, on
# an H100 80GB HBM3 at 700 W: the CPU's fp32 parameters 1.790e-03 off
# fp64, the card's 1.305e-03). The first step's gradient of the whole
# loss misses TOL on any fp32 run too (the CPU's own fp32 against fp64 at
# batch 4: 49 of 371,146 values, up to 5.3 times TOL, every one a sum the
# KL's softmax cancels, scaled by alpha past TOL_ATOL). The gradient of
# each term of the loss, the prediction's squared error and the KL, meets
# TOL there, and is held at the first step's weights; at the card's
# second step's weights its squared error's gradient misses the CPU's by
# 1.6e-3 (the CPU's fp32 5.5e-6 from fp64; a step function not replayed,
# not isolated). HierCorrPool's three encoder convolutions each feed a
# train-mode BatchNorm, which leaves the loss blind to each output
# channel's scale, and Adam's normalised step moves weights whose gradient
# cancels that way (against the weight decay) by a share of the learning
# rate that rounding decides: at batch 100 the CPU's fp32 parameters end
# 1.2e-3 to 2.8e-3 off the same 5 steps in fp64 (by its thread count), and
# on an H100 80GB HBM3 at 700 W the card's 4.3e-3, its fifth loss 7.9e-5
# off fp64's at a loss of 0.085 (the CPU's 1.1e-6), while the gradient at
# each of the card's steps is within TOL of the CPU's. So for these
# methods the gradient of each term of the loss is held, card against CPU
# by _hold's rule, at the weights of the card's first steps, as many as
# the method's entry here (the CPU starting each from the card's weights,
# replaying its top-k selections or ReLU masks).
# The free-running steps' parameters are held as any method's unless the
# CPU's own fp32 parameters miss fp64 by more than PARAM_MAX_DIFF too, and
# then their losses are held unless the gradient was held at every step.
GRADIENT_HELD = {"HAGCN": 1, "HierCorrPool": PARITY_STEPS}


def _steps(engine: Engine, xs, ys, device: str, dtype=torch.float32,
           states=None):
    """PARITY_STEPS train steps on ``engine``; returns the losses. With a
    list ``states``, appends the model's state_dict (on the host) before
    each step."""
    losses = []
    for x, y in zip(xs, ys):
        if states is not None:
            states.append({k: v.detach().cpu().clone()
                           for k, v in engine.model.state_dict().items()})
        losses.append(float(engine.train_step(
            torch.from_numpy(x).to(device, dtype),
            torch.from_numpy(y).to(device, dtype))))
    return np.array(losses)


def _term_gradients(model, x, y, device: str, dtype=torch.float32):
    """``{term: the gradient of every parameter as one flat fp64 vector on
    the host}`` for each term of the model's training loss, the
    prediction's mean squared error and, for an auxiliary-loss model, the
    auxiliary term, at the model's weights on one batch."""
    model = model.to(device, dtype).train()
    out = model(torch.from_numpy(x).to(device, dtype))
    pred, aux = out if isinstance(out, tuple) else (out, None)
    mse = torch.mean((pred - torch.from_numpy(y).to(device, dtype)) ** 2)
    params = list(model.parameters())
    terms = [("squared error", mse)] + ([] if aux is None
                                        else [("auxiliary", aux)])
    out = {}
    for term, value in terms:
        grads = torch.autograd.grad(value, params, retain_graph=True,
                                    allow_unused=True)
        out[term] = torch.cat([
            (g if g is not None else torch.zeros_like(p)).detach().double()
            .cpu().reshape(-1) for g, p in zip(grads, params)])
    return out


def _hold_term_gradients(method: str, seeded, x, y, step: int) -> None:
    """The gradient of each term of ``method``'s loss at ``seeded()``'s
    weights on one batch, card against CPU by :func:`_hold` (the fp64
    witness the same on the CPU on the plain recurrence), the CPU
    replaying the card's top-k selections, or for a method in KINKED its
    ReLU masks."""
    sel = (_Selections(method) if method in RANKED
           else _Kinks() if method in KINKED else None)
    with _during(sel, "record"):
        card = _term_gradients(seeded(), x, y, "cuda")
    with _during(sel, "replay"):
        cpu = _term_gradients(seeded(), x, y, "cpu")

    @functools.cache
    def exact():
        with _plain_recurrence(), _during(sel, "replay"):
            return _term_gradients(seeded(torch.float64), x, y, "cpu",
                                   torch.float64)

    if sel:
        sel.report(method, f"the loss terms' gradients at step {step}")
    for term in card:
        _hold(f"train parity {method}: step {step}'s gradient of the {term} "
              f"term, card vs cpu ({card[term].numel()} values)",
              card[term], cpu[term], lambda term=term: exact()[term])


def _train_parity(method: str) -> None:
    """PARITY_STEPS steps at batch 100 on the card and on the CPU from the
    same weights on the same batches, dropout off, cuDNN deterministic and
    without TF32 for this phase; a ranked method's CPU steps replay the
    card's top-k selections (:class:`_Selections`). Where the losses or the
    parameters miss, both sides are held against the same steps in fp64 on
    the CPU: the card within the same tolerance of them and the closer of
    the two. A method in GRADIENT_HELD also holds the gradient of each term
    of its loss at the weights of the card's first steps, by
    :func:`_hold`."""
    torch.backends.cudnn.deterministic = True
    torch.manual_seed(0)
    sd = build_model(method, "CMAPSS", "FD001").state_dict()

    def seeded(dtype=torch.float32):
        model = build_model(method, "CMAPSS", "FD001")
        model.load_state_dict(sd)
        return _no_dropout(model.to(dtype))

    def engine(device, dtype=torch.float32):
        return Engine(seeded(dtype), get_algorithm_spec(method),
                      train_params("CMAPSS", "FD001", method), device=device)

    engines = {device: engine(device) for device in ("cuda", "cpu")}
    rng = np.random.default_rng(2)
    xs = rng.normal(size=(PARITY_STEPS, SERVE_BATCH, 14, 50)).astype(
        np.float32)
    ys = rng.uniform(size=(PARITY_STEPS, SERVE_BATCH, 1)).astype(np.float32)

    path = _path(method)
    sel = _Selections(method) if method in RANKED else None
    states = [] if method in GRADIENT_HELD else None
    _reset()
    with _during(sel, "record"):
        card = _steps(engines["cuda"], xs, ys, "cuda", states=states)
    torch.cuda.synchronize()
    fwd_launches, bwd_launches = _counts(path.kernel)
    _only_its_kernel(method, "train parity")
    # Dropout is off here, so every training forward takes the kernel.
    want = (path.per_forward * PARITY_STEPS,
            path.per_forward * path.bwd_per_call * PARITY_STEPS)
    if (fwd_launches, bwd_launches) != want:
        raise AssertionError(f"expected (forward, backward) launches {want}, "
                             f"got {(fwd_launches, bwd_launches)}")
    with _during(sel, "replay"):
        cpu = _steps(engines["cpu"], xs, ys, "cpu")
    if sel:
        sel.report(method, f"{PARITY_STEPS} training steps")
    for i, state in enumerate((states or [])[:GRADIENT_HELD.get(method)]):
        def at_step(dtype=torch.float32, state=state):
            model = build_model(method, "CMAPSS", "FD001")
            model.load_state_dict(state)
            return _no_dropout(model.to(dtype))
        _hold_term_gradients(method, at_step, xs[i], ys[i], step=i + 1)
    torch.backends.cudnn.deterministic = False

    params = {dev: {k: p.detach().cpu().double() for k, p in
                    engines[dev].model.named_parameters()}
              for dev in ("cuda", "cpu")}
    param_diff = max((p - params["cpu"][k]).abs().max().item()
                     for k, p in params["cuda"].items())
    print(f"train parity {method}: {PARITY_STEPS} steps at batch "
          f"{SERVE_BATCH}, losses card {card.tolist()} cpu {cpu.tolist()}; "
          f"max |param card - cpu| {param_diff:.3e}; launches forward "
          f"{fwd_launches}, backward {bwd_launches}")

    def exact():
        """The same steps in fp64 on the CPU: (losses, parameters)."""
        e64 = engine("cpu", torch.float64)
        with _plain_recurrence(), _during(sel, "replay"):
            losses = _steps(e64, xs, ys, "cpu", torch.float64)
        return losses, {k: p.detach() for k, p in
                        e64.model.named_parameters()}

    loss_miss = not np.all(np.abs(card - cpu)
                           <= LOSS_ATOL + LOSS_RTOL * np.abs(cpu))
    param_miss = not param_diff < PARAM_MAX_DIFF
    if not (loss_miss or param_miss):
        return
    losses64, params64 = exact()
    worst = max(params["cuda"], key=lambda k: (
        params["cuda"][k] - params["cpu"][k]).abs().max().item())
    off = {dev: (float(np.abs(run - losses64).max()),
                 max((p - params64[k]).abs().max().item()
                     for k, p in params[dev].items()))
           for dev, run in (("cuda", card), ("cpu", cpu))}
    print(f"train parity {method}: missed the CPU (losses "
          f"{'missed' if loss_miss else 'held'}, parameters by "
          f"{param_diff:.3e}, most in {worst}); against the same steps "
          f"in fp64 on the CPU the card's losses are off by "
          f"{off['cuda'][0]:.3e} and its parameters by "
          f"{off['cuda'][1]:.3e}, the CPU's fp32 by {off['cpu'][0]:.3e} "
          f"and {off['cpu'][1]:.3e}")
    waived = method in GRADIENT_HELD and not off["cpu"][1] < PARAM_MAX_DIFF
    every_step = GRADIENT_HELD.get(method) == PARITY_STEPS
    if waived:
        print(f"train parity {method}: no fp32 run here holds the "
              f"parameters within {PARAM_MAX_DIFF} of fp64, so they are not "
              f"held; the gradient of each term of the loss held at the "
              f"weights of the card's first {GRADIENT_HELD[method]} "
              f"step(s)" + ("; with it held at every step, the "
                            "free-running losses are not held either"
                            if every_step else ""))
    if loss_miss and not (waived and every_step) and not (
            np.all(np.abs(card - losses64)
                   <= LOSS_ATOL + LOSS_RTOL * np.abs(losses64))
            and off["cuda"][0] < off["cpu"][0]):
        raise AssertionError(f"train parity {method}: the card's losses "
                             f"miss the CPU's, and miss fp64's or are not "
                             f"the closer to them")
    if param_miss and not waived and not (
            off["cuda"][1] < PARAM_MAX_DIFF
            and off["cuda"][1] < off["cpu"][1]):
        raise AssertionError(f"train parity {method}: the card's "
                             f"parameters miss the CPU's by {param_diff}, "
                             f"and fp64's by {off['cuda'][1]}, the CPU's "
                             f"fp32 by {off['cpu'][1]}")


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


def _train_entry_point(method: str, fd001):
    """The main path: ``cli.main`` trains one epoch of ``method`` on the
    card; then ``cli.main --eval_torch_checkpoint`` evaluates the epoch's
    checkpoint.pt, whose metrics must be the trainer's own. Returns the
    kernel's (forward, backward) launches and its backward calls over the
    training run, and its launches over the evaluation."""
    (train_x, _), test_x, data_root = fd001
    save_dir = os.path.join(os.path.dirname(data_root), "logs")
    path = _path(method)
    _reset()
    t0 = time.perf_counter()
    results = cli.main([
        "--GNN_method", method, "--dataset", "CMAPSS", "--dataset_id",
        "FD001", "--data_path", data_root, "--save_dir", save_dir,
        "--epochs", "1", "--num_runs", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd_launches, bwd_launches = _counts(path.kernel)
    bwd_calls = getattr(path.kernel, "bwd_calls", 0)
    _only_its_kernel(method, "train entry point")

    run_dir = os.path.join(save_dir, "GNN_RUL", "run_1", f"{method}_run_0")
    with open(os.path.join(run_dir, "logs_run_0.log")) as f:
        losses = [float(v) for v in re.findall(r"loss\t: (\S+)", f.read())]
    with open(os.path.join(run_dir, "results.csv")) as f:
        rows = [line.strip().split(",") for line in f if line.strip()]
    best = results[0][None]
    print(f"train entry point {method}: cli.main, 1 epoch of {len(train_x)} "
          f"windows on the card in {wall:.2f} s (build, upload and "
          f"evaluation included); epoch loss {losses}; best (Score_v1, "
          f"Score_v2, MAE, RMSE) {best}; launches forward {fwd_launches}, "
          f"backward {bwd_launches} in {bwd_calls} calls")
    if len(losses) != 1 or not np.isfinite(losses[0]):
        raise AssertionError(f"epoch losses {losses}")
    if rows[0] != ["Score_v1", "Score_v2", "MAE", "RMSE"] or len(rows) != 2 \
            or not np.isfinite([float(v) for v in rows[1]]).all():
        raise AssertionError(f"results.csv holds {rows}")
    steps = -(-len(train_x) // SERVE_BATCH)
    evals = -(-len(test_x) // SERVE_BATCH)
    want = (path.train_per_forward * steps + path.per_forward * evals,
            path.train_per_forward * path.bwd_per_call * steps)
    if (fwd_launches, bwd_launches) != want:
        raise AssertionError(f"expected (forward, backward) launches {want}, "
                             f"got {(fwd_launches, bwd_launches)}")

    if method == "STAGNN":
        _adjacency_margin("FD001 test windows", test_x)
    ckpt_path = os.path.join(run_dir, "checkpoint.pt")
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    on_card, on_cpu = (serving_model(method, "CMAPSS", "FD001",
                                     ckpt["model_dict"],
                                     batch_size=SERVE_BATCH, device=dev)
                       for dev in ("cuda", "cpu"))
    sel = _Selections(method) if method in RANKED else None
    with _during(sel, "record"):
        got = on_card(test_x)
    with _during(sel, "replay"):
        want_pred = on_cpu(test_x)
    if sel:
        sel.report(method, "FD001 test windows, trained weights")
    if got.shape != (len(test_x),) or not np.isfinite(got).all():
        raise AssertionError(f"checkpoint serves {got.shape} or non-finite")
    np.testing.assert_allclose(got, want_pred, atol=SERVE_ATOL,
                               rtol=SERVE_RTOL)
    print(f"train entry point {method}: checkpoint.pt serves {len(test_x)} "
          f"test windows on the card as on the CPU (atol={SERVE_ATOL}, "
          f"rtol={SERVE_RTOL})")

    _reset()
    evaluated = cli.main([
        "--GNN_method", method, "--dataset", "CMAPSS", "--dataset_id",
        "FD001", "--data_path", data_root, "--save_dir", save_dir,
        "--eval_torch_checkpoint", ckpt_path])
    torch.cuda.synchronize()
    eval_launches = _counts(path.kernel)[0]
    _only_its_kernel(method, "evaluate_only")
    eval_diff = float(np.max(np.abs(np.subtract(evaluated[None], best))
                             / np.maximum(np.abs(best), 1e-30)))
    print(f"train entry point {method}: cli.main --eval_torch_checkpoint "
          f"on checkpoint.pt: (Score_v1, Score_v2, MAE, RMSE) "
          f"{evaluated[None]}, the trainer's {best}, largest relative "
          f"difference {eval_diff:.3e}; launches forward {eval_launches}")
    np.testing.assert_allclose(evaluated[None], best, rtol=1e-5)
    if eval_launches != path.per_forward * evals:
        raise AssertionError(f"evaluate_only launched {eval_launches}, not "
                             f"{path.per_forward * evals}")
    art_path = os.path.join(run_dir, "model.pt2")
    line = export.main(["--checkpoint", os.path.join(run_dir, "checkpoint.pt"),
                        "--GNN_method", method, "--dataset", "CMAPSS",
                        "--dataset_id", "FD001", "--out", art_path,
                        "--batch_size", str(SERVE_BATCH),
                        "--max_rul", str(MAX_RUL)])
    got_art = export.load_artifact(art_path)(test_x)
    np.testing.assert_allclose(got_art, got, atol=ARTIFACT_ATOL,
                               rtol=ARTIFACT_RTOL)
    print(f"train entry point {method}: python -m gnn_rul_tpu_torch.export "
          f"wrote {line['bytes']} bytes; the artifact serves the test "
          f"windows as the live model on the card does (atol="
          f"{ARTIFACT_ATOL}, rtol={ARTIFACT_RTOL})")
    return fwd_launches, bwd_launches, bwd_calls, eval_launches


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


def _gat_bound_ms(b: int, n: int, d: int, batched: bool):
    """Least time for the graph attention on an H100 SXM, the larger of its
    bytes at the HBM rate and its fp32 operations at the fp32 peak: wh, f1,
    f2, adj (one (N, N) when shared) and bias read and out written;
    2*B*N^2*D for the product with wh and 6*B*N^2 for the logits, the
    leaky_relu, the exponent, the normalisation and the mask."""
    nbytes = 4 * (2 * b * n * d + 2 * b * n + (b if batched else 1) * n * n
                  + 1)
    flops = 2 * b * n * n * d + 6 * b * n * n
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOP_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def _gat_times(cases):
    """{case: (kernel ms, plain ms, bound ms, bound by)} at ``cases`` of
    GAT_CASES. No single PyTorch call computes a softmax followed by a
    multiplicative mask and the product, so there is no library time."""
    times = {}
    for case in cases:
        b, n, d, batched, bias, slope = case
        args = _gat_inputs(b, n, d, batched, bias, seed=0)
        times[case] = (
            _graph_ms(lambda: fused_gat.fused_gat.forward(*args, slope)),
            _graph_ms(lambda: fused_gat.fused_gat_plain(*args, slope)),
            *_gat_bound_ms(b, n, d, batched))
        print(f"times [{SMI}]: fused_gat B={b} N={n} D={d} adj="
              f"{'per-graph' if batched else 'shared'}: " + "kernel {:.6f} "
              "ms, plain {:.6f} ms, bound {:.6f} ms ({}); library none"
              .format(*times[case]))
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


def _lstm_bound_ms(t: int, b: int, h: int, backward: bool = False):
    """Least time for the recurrence on an H100 SXM, the larger of its bytes
    at the HBM rate and its fp32 operations at the fp32 peak, per (step,
    direction, column). Forward: xg and w_hh read, ys and the c trajectory
    written; 8H^2 for the recurrent product, 4H gate additions, 5H
    activations and 5H for the cell. Backward: xg, w_hh, ys, cs, dys and
    dc_fin read, dxg and dw_hh written; three recurrent products (the
    recomputed gates, dh, dW: 24H^2) and 4H + 5H + 5H + 16H elementwise."""
    rows = t * 2 * b
    if backward:
        nbytes = 4 * (rows * (4 * h + 3 * h + 4 * h) + 2 * 2 * h * 4 * h
                      + 2 * b * h)
        flops = rows * (24 * h * h + 30 * h)
    else:
        nbytes = 4 * (rows * (4 * h + 2 * h) + 2 * h * 4 * h)
        flops = rows * (8 * h * h + 14 * h)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / FP32_FLOP_PER_S * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def _event_ms(fn, inner: int = 10, reps: int = 5) -> float:
    """Median device ms of one ``fn()`` from CUDA events around ``inner``
    back-to-back calls (no CUDA graph: cuDNN's LSTM is timed as a caller
    would run it), after 3 warmup calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


class _Clocks:
    """Samples the card's SM clock and power draw every 100 ms with
    nvidia-smi while the block runs; on leaving it stops the sampler and
    prints their range."""

    def __enter__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, stderr=subprocess.DEVNULL, text=True)
        return self

    def __exit__(self, *exc):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=60)
        rows = []
        for line in out.splitlines():
            fields = [f.strip() for f in line.split(",")]
            if len(fields) == 3 and all(f.replace(".", "", 1).isdigit()
                                        for f in fields):
                rows.append([float(f) for f in fields])
        if rows:
            sm, top, watts = (sorted(col) for col in zip(*rows))
            print(f"clocks during the kernel timings [{SMI}]: {len(rows)} "
                  f"samples, SM clock {sm[0]:.0f}/{statistics.median(sm):.0f}"
                  f"/{sm[-1]:.0f} MHz (min/median/max; max possible "
                  f"{top[-1]:.0f}), power draw {watts[0]:.1f}/"
                  f"{statistics.median(watts):.1f}/{watts[-1]:.1f} W")
        return False


def _lstm_times(shapes):
    """{(T, B, H): {"fwd": (kernel, plain, bound, bound by, cuDNN),
    "bwd": (...)}} in ms. The plain versions loop over T in Python, so
    their CUDA graphs hold fewer calls; cuDNN's ``torch.nn.LSTM(H, H,
    bidirectional=True, batch_first=True)`` on x (B, T, H) includes its
    input projection: forward under no_grad for the forward, forward and
    backward minus the training forward for the backward."""
    kernel = fused_lstm.lstm_recurrence
    out = {}
    for t, b, h in shapes:
        xg, w, dys, dcf = _lstm_inputs(t, b, h, seed=0)
        ys, cs, _ = kernel.forward(xg, w)
        inner = max(1, 500 // t)
        lib = torch.nn.LSTM(h, h, bidirectional=True, batch_first=True).cuda()
        x = torch.randn(b, t, h, device="cuda", requires_grad=True)
        g = torch.randn(b, t, 2 * h, device="cuda")

        def lib_fwd():
            with torch.no_grad():
                lib(x)

        def lib_train():
            lib(x)[0].backward(g)

        train_fwd = _event_ms(lambda: lib(x))
        # The plain versions' Python time loops take ~0.5 (forward) and
        # ~0.9 s (backward) a call at HAGCN's T = 14,000: fewer replays.
        plain_reps = 21 if t <= 2000 else 3
        # Up to 50 kernel calls a graph, fewer where a call is long: at
        # T = 14,000 (~17 ms a call) one call a graph, whose replay spends
        # well under 0.1% of its time launching; the phase takes ~35 s less.
        calls = max(1, min(50, 20000 // t))
        out[(t, b, h)] = {
            "fwd": (_graph_ms(lambda: kernel.forward(xg, w), inner=calls),
                    _graph_ms(lambda: fused_lstm.lstm_trajectory_plain(xg, w),
                              inner=inner, reps=plain_reps),
                    *_lstm_bound_ms(t, b, h), _event_ms(lib_fwd)),
            "bwd": (_graph_ms(lambda: kernel.backward(xg, w, ys, cs, dys,
                                                      dcf), inner=calls),
                    _graph_ms(lambda: fused_lstm.lstm_recurrence_bwd_plain(
                        xg, w, ys, cs, dys, dcf), inner=max(1, inner // 3),
                        reps=plain_reps),
                    *_lstm_bound_ms(t, b, h, backward=True),
                    _event_ms(lib_train) - train_fwd),
        }
        for part, name in (("fwd", "lstm_recurrence"),
                           ("bwd", "lstm_recurrence_bwd")):
            row = out[(t, b, h)][part]
            print(f"times [{SMI}]: {name} T={t} B={b} H={h}: kernel "
                  f"{row[0]:.6f} ms ({row[0] / t * 1e3:.3f} us per step), "
                  f"plain {row[1]:.6f} ms, bound {row[2]:.6f} ms ({row[3]}), "
                  f"cuDNN nn.LSTM {row[4]:.6f} ms")
        split, per_call = _lstm_bwd_split(xg, w, ys, cs, dys, dcf)
        print(f"times [{SMI}]: lstm_recurrence_bwd T={t} B={b} H={h} by "
              f"launch (torch.profiler, us per launch over the launches "
              f"it recorded of 11; {per_call:g} launches per call by the "
              f"wrapper's count): " + ", ".join(
                  f"{name} {us:.3f} us ({n} of 11 recorded)"
                  for name, (us, n) in split.items()))
    return out


def _lstm_bwd_split(xg, w, ys, cs, dys, dcf, reps: int = 10):
    """({kernel name: (device us per launch, launches the profiler
    recorded)}, the wrapper's launches per call) of the backward's four
    kernels: torch.profiler over one warm-up call and ``reps`` calls, each
    kernel's time over the launches the trace recorded. The trace can miss
    launches (on an H100 it recorded 9 of 11 of one kernel), so the
    launches per call come from the wrapper's count."""
    kernel = fused_lstm.lstm_recurrence
    kernel.backward(xg, w, ys, cs, dys, dcf)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        kernel.backward(xg, w, ys, cs, dys, dcf)
        torch.cuda.synchronize()
        before = kernel.bwd_launches
        for _ in range(reps):
            kernel.backward(xg, w, ys, cs, dys, dcf)
        torch.cuda.synchronize()
        per_call = (kernel.bwd_launches - before) / reps
    split = {}
    for name in LSTM_BWD_KERNELS:
        events = [e for e in prof.key_averages()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and name in e.key]
        count = sum(e.count for e in events)
        split[name] = (sum(e.device_time_total for e in events) / count
                       if count else float("nan"), count)
    return split, per_call


def _lstm_cluster_times(t: int = 200, h: int = 120) -> None:
    """The kernels' time per step at H = ``h`` at each B of CLUSTER_BS,
    where the plan takes another cluster size; every grid fits one wave, so
    each CTA's step is the same work at each B."""
    kernel = fused_lstm.lstm_recurrence
    for b in CLUSTER_BS:
        xg, w, dys, dcf = _lstm_inputs(t, b, h, seed=0)
        ys, cs, _ = kernel.forward(xg, w)
        for part, call in (
                ("forward", lambda: kernel.forward(xg, w)),
                ("backward", lambda: kernel.backward(xg, w, ys, cs, dys,
                                                     dcf))):
            c = kernel.plan(h, b, part == "backward")["cluster"]
            ms = _graph_ms(call)
            print(f"times [{SMI}]: lstm T={t} B={b} H={h} {part}, cluster "
                  f"of {c}: {ms:.6f} ms ({ms / t * 1e3:.3f} us per step)")


def _serve_times(method: str, fixed, symbolic, x100, x1000) -> None:
    for name, model, xs in (("batch 100", fixed, x100),
                            ("batch 1000", symbolic, x1000)):
        req_ms = _request_ms(model, xs)
        x_dev = torch.from_numpy(xs).cuda()
        with torch.inference_mode():
            fwd_ms = _graph_ms(lambda: model.model(x_dev), inner=10)
        print(f"serve {method} {name} [{SMI}]: {req_ms:.4f} ms/request, "
              f"{len(xs) / req_ms * 1e3:.1f} samples/s; the forward's device "
              f"work alone (CUDA graph) {fwd_ms:.4f} ms")
        _profile(f"serve {method} {name}", lambda: model(xs), req_ms,
                 "request")


def _artifact_times(method: str, artifact, symbolic, x100, x1000) -> None:
    """A request of 100 and of 1000 through the symbolic-batch artifact and
    the live symbolic-batch model, in turns: live, artifact, artifact,
    live."""
    for xs in (x100, x1000):
        live_a, art_a, art_b, live_b = (
            _request_ms(model, xs)
            for model in (symbolic, artifact, artifact, symbolic))
        print(f"serve {method} request of {len(xs)} [{SMI}]: artifact "
              f"{art_a:.4f} / {art_b:.4f} ms/request, live model "
              f"{live_a:.4f} / {live_b:.4f} (in turns: live, artifact, "
              f"artifact, live)")
        _profile(f"serve artifact {method} request of {len(xs)}",
                 lambda: artifact(xs), art_a, "request")


def _train_times(method: str, fd001) -> None:
    (train_x, train_y), _, _ = fd001
    torch.manual_seed(0)
    engine = Engine(build_model(method, "CMAPSS", "FD001"),
                    get_algorithm_spec(method),
                    train_params("CMAPSS", "FD001", method))
    xb = torch.from_numpy(train_x[:SERVE_BATCH]).cuda()
    yb = torch.from_numpy(train_y[:SERVE_BATCH]).cuda()
    step_ms = _step_ms(engine, xb, yb)
    # Outside the timed epoch: the data's upload, and one step at the
    # remainder batch's shape (31 rows), the one shape the step times above
    # did not warm.
    engine._device_data(train_x, train_y)
    rem = len(train_x) % SERVE_BATCH
    if rem:
        engine.train_step(xb[:rem], yb[:rem])
    t0 = time.perf_counter()
    engine.run_epoch(train_x, train_y, 1, shuffle=True)
    epoch_s = time.perf_counter() - t0
    steps = -(-len(train_x) // SERVE_BATCH)
    path = _path(method)
    print(f"train {method} [{SMI}]: {step_ms:.4f} ms per step at batch "
          f"{SERVE_BATCH} (median of 30); one epoch of {len(train_x)} "
          f"windows in {steps} steps {epoch_s:.4f} s, "
          f"{len(train_x) / epoch_s:.1f} samples/s; launches per step "
          f"forward {path.train_per_forward}, backward "
          f"{path.train_per_forward * path.bwd_per_call}")
    _profile(f"train step {method}", lambda: engine.train_step(xb, yb),
             step_ms, "step")


class _Phases:
    """The wall time of each phase of :func:`main`, printed at its end."""

    def __init__(self):
        self.last = time.perf_counter()
        self.times = []

    def mark(self, name: str) -> None:
        now = time.perf_counter()
        self.times.append((name, now - self.last))
        self.last = now

    def report(self) -> None:
        print("phases (wall s): " + ", ".join(
            f"{name} {s:.1f}" for name, s in self.times)
              + f"; total {sum(s for _, s in self.times):.1f}")


def main() -> None:
    phases = _Phases()
    kind = _device()
    _build()
    phases.mark("device and build")
    max_err = _kernel_vs_plain()
    bwd_max_err = _bwd_vs_plain()
    lstm_err, lstm_bwd_err = _lstm_vs_plain()
    gat_err = _gat_vs_plain()
    phases.mark("kernels vs plain")
    served = {m: _serve(m) for m in METHODS}
    tiers = _serve_tiers()
    phases.mark("serve")
    artifacts = {}
    with tempfile.TemporaryDirectory() as tmp:
        for method in METHODS:
            artifacts[method] = _artifacts(method, served[method], tmp)
            phases.mark(f"artifacts {method}")
    for method in METHODS:
        _train_parity(method)
    phases.mark("train parity")
    with tempfile.TemporaryDirectory() as tmp:
        fd001 = _write_fd001(tmp)
        trained = {m: _train_entry_point(m, fd001) for m in METHODS}
        phases.mark("train entry point")

        kernel = fused_gnn.fused_dot_graph_spmm
        fwd = _kernel_times("fused_dot_graph_spmm", KERNEL_CASES[:2], kernel,
                            fused_gnn.fused_dot_graph_spmm_plain,
                            backward=False)
        bwd = _kernel_times("fused_dot_graph_spmm_bwd", KERNEL_CASES[:2],
                            kernel.backward,
                            fused_gnn.fused_dot_graph_spmm_bwd_plain,
                            backward=True)
        phases.mark("kernel times, dot graph")
        with _Clocks():
            # HAGCN's three layers at a batch of 100 (H = 60, 120) and its
            # widest at a request of 1000 (T = 14,000).
            lstm = _lstm_times([(100, 70, 24), (100, 70, 48),
                                (1000, 70, 48), (1400, 5, 60),
                                (1400, 5, 120), (14000, 5, 120),
                                (100, 544, 30)])
            _lstm_cluster_times()
            phases.mark("kernel times, LSTM")
            # The serving and training shapes of both models, and the two
            # check shapes of few large graphs.
            gat = _gat_times([GAT_CASES[k] for k in (0, 1, 2, 3, 4, 7)])
        phases.mark("kernel times, attention")
        for method in METHODS:
            _serve_times(method, *served[method][:4])
            _artifact_times(method, artifacts[method][0],
                            *served[method][1:4])
            _train_times(method, fd001)
            phases.mark(f"times {method}")
        for tier, models in tiers.items():
            _serve_times(tier, *models)
        phases.mark("times, tiers")
    phases.report()

    def entry(name, times, max_abs_err, launches, **extra):
        ms, plain_ms, bound_ms, bound_by, *library = times
        return {"name": name, "route": "cuda", **extra,
                "launches": launches, "max_abs_err": max_abs_err, "ms": ms,
                "kernel_ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by,
                "library_ms": library[0] if library else None}

    def at(times, prefix):
        ms, plain_ms, bound_ms, _ = times[:4]
        return {f"{prefix}_ms": ms, f"{prefix}_plain_ms": plain_ms,
                f"{prefix}_bound_ms": bound_ms}

    def hagcn(part, k):
        """HAGCN's launches in its epoch and the kernel's times at its
        shapes: T = 1,400 at H = 60 and 120, T = 14,000 at H = 120."""
        out = {"launches_hagcn_epoch": trained["HAGCN"][k]}
        for shape, prefix in (((1400, 5, 60), "hagcn_t1400_h60"),
                              ((1400, 5, 120), "hagcn_t1400_h120"),
                              ((14000, 5, 120), "hagcn_t14000_h120")):
            out.update(at(lstm[shape][part], prefix),
                       **{f"{prefix}_library_ms": lstm[shape][part][4]})
        return out

    lstm_shape = (100, 70, 48)
    print(json.dumps({"kernels": [
        entry("fused_dot_graph_spmm", fwd[KERNEL_CASES[0]], max_err,
              trained["FC_STGNN"][0],
              source="gnn_rul_tpu_torch/csrc/fused_gnn.cu",
              replaces="gnn_rul_tpu/ops/pallas/fused_gnn.py:45 (_kernel), "
                       "gnn_rul_tpu/ops/pallas/fused_gnn.py:116 "
                       "(_packed_kernel)",
              launches_serve=served["FC_STGNN"][4],
              launches_artifact=artifacts["FC_STGNN"][1],
              plan=fused_gnn.fwd_plan(*KERNEL_CASES[0]),
              plan_b1000=fused_gnn.fwd_plan(*KERNEL_CASES[1]),
              **at(fwd[KERNEL_CASES[1]], "b1000")),
        entry("fused_dot_graph_spmm_bwd", bwd[KERNEL_CASES[0]], bwd_max_err,
              trained["FC_STGNN"][1],
              source="gnn_rul_tpu_torch/csrc/fused_gnn_bwd.cu",
              replaces="gnn_rul_tpu/ops/pallas/fused_gnn.py:235 "
                       "(_bwd_kernel)",
              launches_per_call=trained["FC_STGNN"][1]
              / trained["FC_STGNN"][2],
              **at(bwd[KERNEL_CASES[1]], "b1000")),
        entry("fused_lstm", lstm[lstm_shape]["fwd"], lstm_err,
              trained["LOGO"][0], source="gnn_rul_tpu_torch/csrc/fused_lstm.cu",
              replaces="gnn_rul_tpu/ops/pallas/fused_lstm.py:77 (_fwd_kernel)",
              shape="T=100 B=70 H=48", library="torch.nn.LSTM forward",
              launches_serve=served["LOGO"][4],
              launches_artifact=artifacts["LOGO"][1],
              launches_eval=trained["LOGO"][3], **hagcn("fwd", 0),
              launches_hagcn_serve=served["HAGCN"][4],
              launches_hagcn_artifact=artifacts["HAGCN"][1],
              launches_hagcn_eval=trained["HAGCN"][3]),
        entry("fused_lstm_bwd", lstm[lstm_shape]["bwd"], lstm_bwd_err,
              trained["LOGO"][1],
              source="gnn_rul_tpu_torch/csrc/fused_lstm_bwd.cu",
              replaces="gnn_rul_tpu/ops/pallas/fused_lstm.py:106 "
                       "(_bwd_kernel)",
              shape="T=100 B=70 H=48",
              library="torch.nn.LSTM forward+backward minus forward",
              **hagcn("bwd", 1)),
        entry("fused_gat", gat[GAT_CASES[0]], gat_err, trained["STAGNN"][0],
              source="gnn_rul_tpu_torch/csrc/fused_gat.cu",
              replaces="gnn_rul_tpu/ops/pallas/fused_gat.py:46 (_kernel)",
              shape="B=100 N=14 D=64 per-graph adj (STAGNN)",
              launches_serve=served["STAGNN"][4],
              launches_artifact=artifacts["STAGNN"][1],
              launches_stfa_serve=served["STFA"][4],
              launches_stfa_artifact=artifacts["STFA"][1],
              launches_stfa_epoch=trained["STFA"][0],
              stfa_ms=gat[GAT_CASES[2]][0],
              stfa_plain_ms=gat[GAT_CASES[2]][1],
              stfa_bound_ms=gat[GAT_CASES[2]][2],
              **at(gat[GAT_CASES[3]], "stfa_b25000")),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))


# One turn of :func:`_turns`, in the tree it runs from: the dot-graph
# forward at B = 100 and 1000 and at the two few-large-graph cases, the
# backward at B = 100 and 1000 and the attention at its six timed shapes,
# through functions that every tree since the attention kernel's has.
_TURN = ("import chip_smoke as c; c._device(); c._build(); "
         "k = c.fused_gnn.fused_dot_graph_spmm; "
         "c._kernel_times('fused_dot_graph_spmm', "
         "[c.KERNEL_CASES[i] for i in (0, 1, 4, 5)], k, "
         "c.fused_gnn.fused_dot_graph_spmm_plain, backward=False); "
         "c._kernel_times('fused_dot_graph_spmm_bwd', c.KERNEL_CASES[:2], "
         "k.backward, c.fused_gnn.fused_dot_graph_spmm_bwd_plain, "
         "backward=True); "
         "c._gat_times([c.GAT_CASES[i] for i in (0, 1, 2, 3, 4, 7)])")


# A turn of the host's times: each model's training step at batch 100 and
# a request of 100 through the live model, through functions that every
# tree since STFA's port has.
_HOST_TURN = """
import numpy as np, torch
import chip_smoke as c
c._device(); c._build()
rng = np.random.default_rng(0)
x = rng.normal(size=(c.SERVE_BATCH, 14, 50)).astype(np.float32)
y = rng.uniform(size=(c.SERVE_BATCH, 1)).astype(np.float32)
for m in c.METHODS:
    torch.manual_seed(0)
    engine = c.Engine(c.build_model(m, "CMAPSS", "FD001"),
                      c.get_algorithm_spec(m),
                      c.train_params("CMAPSS", "FD001", m))
    step = c._step_ms(engine, torch.from_numpy(x).cuda(),
                      torch.from_numpy(y).cuda())
    model = c.serving_model(m, "CMAPSS", "FD001", c._seeded_state_dict(m),
                            batch_size=c.SERVE_BATCH)
    print(f"host turn {m} [{c.SMI}]: training step {step:.4f} ms, request "
          f"of {c.SERVE_BATCH} {c._request_ms(model, x):.4f} ms", flush=True)
"""


def _turns(parent: str, turn: str = _TURN) -> None:
    """Runs ``turn`` (the kernels' times, or ``_HOST_TURN``) in the tree at
    ``parent`` (an earlier commit, unpacked) and in this one in turns,
    parent, this, this, parent, on one card; each turn is a process of its
    own that builds its tree's kernels."""
    for label, cwd in (("parent", parent), ("change", "."), ("change", "."),
                       ("parent", parent)):
        print(f"turn {label}: {os.path.abspath(cwd)}", flush=True)
        subprocess.run([sys.executable, "-c", turn], cwd=cwd, check=True)


if __name__ == "__main__":
    main()
