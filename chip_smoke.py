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
   LOGO's, HAGCN's, LOGO_bearing's (B = 200 at PHM2012, 544 at XJTU-SY),
   ragged and H = 1024 (T, B, H), and on each side of every point where
   the kernels' plan changes, in H at two B and in B at two H (each
   cluster size included); the graph attention at STAGNN's and STFA's (B,
   N, D), both adjacency layouts, GAT_LSTM's (the shared path graph) and
   GDAGDL's (graphs of importance > 0), ragged shapes, adjacency rows and
   whole graphs of 0 (the answer there exactly 0), and on each side of
   every point where its plan changes;
4. serve: FC_STGNN, LOGO, STAGNN, STFA, HAGCN, RGCNU, GRU_CM, STGNN,
   DVGTformer, HierCorrPool, ASTGCNN and ST_Conv on FD001, and
   HierCorrPool_bearing, ST_GCN, SAGCN, AGCN_TF, STMSGCN, STNet, GAT_LSTM,
   GDAGDL and LOGO_bearing on PHM2012 Condition_1 (windows of (1, 2560)),
   at full width with seeded weights through ``serving_model``; every
   answer against the same weights on the CPU at the same batch, and each
   path's kernel launches counted over that path's run alone (every other
   wrapper's count must stay 0: thirteen methods launch no port kernel);
   then the tier configurations, HierCorrPool at FD004's hparams,
   DVGTformer at N-CMAPSS's (20 sensors), HierCorrPool_bearing and
   LOGO_bearing at XJTU-SY Condition_1's on the raw minute of 32,768
   samples, card against CPU at 100 and 1000 rows, LOGO_bearing's
   recurrence launches counted (the others launch none); for STAGNN,
   whose graph is ``cov > 0``, the smallest |cov| and the adjacency
   entries that differ between card and CPU; for the step functions that
   the CPU replays as the card took them, the margins and the choices that
   differ are printed: HAGCN's and STGNN's top-k, SAGCN's and AGCN_TF's
   frequency bins, STNet's and GDAGDL's node masks (:class:`_Replay`);
5. artifacts: for each model, ``export_serving`` for the card at a
   symbolic batch and at batch 100 (traced on the CPU and moved to the
   card at export), and for the CPU at a symbolic batch; each saved with
   ``save_artifact`` and loaded on the card with ``load_artifact`` (the
   CPU's moved there at load); the registered operator's
   nodes counted in each exported graph; phase 4's requests served through
   each (the 1000-row one through the symbolic ones), every answer held
   against the live model on the card at the same batch, and each
   artifact's kernel launches counted over its own requests;
6. train, parity: for each model, 5 steps (LOGO_bearing 7, across its
   per-batch MultiStepLR's first milestone, each step's lr printed and
   held to the schedule's) at batch 100 on the card and on the CPU from
   the same weights on the same batches, dropout off; losses and
   parameters compared (where either misses, both sides against the same
   steps in fp64 on the CPU, the card to be within the same tolerance of
   them and the closer), for the methods of GRADIENT_HELD the gradient of
   each term of the loss held card against CPU as each kernel is, at the
   weights of the card's first step (HAGCN) or of each of its steps
   (HierCorrPool, its ReLU masks replayed on the CPU; GAT_LSTM), the
   forward and backward launches counted;
7. preprocess: a raw C-MAPSS FD001 tree at its real size through
   ``python -m gnn_rul_tpu_torch.data.preprocess`` (run in this process),
   its windows' labels checked, and FC_STGNN trained one epoch from it
   through ``cli.main`` (the dot-graph kernels' 318 and 316 launches); a
   raw PHM2012 Condition_1 tree of 2,560 x 6 acc files, 50 a bearing, one
   bearing ';'-separated, preprocessed and SAGCN trained one epoch from
   it; pandas is never imported;
8. train, entry point: for each model, ``cli.main`` trains one epoch of a
   synthetic processed FD001 at the real size (the bearing methods: PHM2012
   Condition_1 at FEMTO's real size, 3,674 training snapshots and five
   test bearings) on the card, with the
   kernels' launches counted over that run alone, and the lr after its
   last step read from checkpoint.pt (LOGO_bearing's past all four
   milestones, 1e-3 * 0.5 ** 4); its results.csv and
   checkpoint.pt are read back, the checkpoint serves on the card as on
   the CPU, ``cli.main --eval_torch_checkpoint`` evaluates it on the card
   to the trainer's own final metrics (its launches counted), and
   ``python -m gnn_rul_tpu_torch.export``'s ``main`` exports it to an
   artifact that serves as the live model does;
9. times: CUDA-event medians of each kernel, its plain version and, for
   the LSTM recurrence, cuDNN's ``torch.nn.LSTM``, with the backward's time
   launch by launch (torch.profiler), HAGCN's shapes (T = 1,400 at H = 60
   and 120, T = 14,000 at 120), LOGO_bearing's (H = 30 at B = 200 and
   at XJTU-SY's 544) and H = 120 at the B of each cluster size; the
   attention at GAT_LSTM's (100, 40, 300) and GDAGDL's (12,800, 3, 300)
   too; the serving latency and
   samples/s (the four tier configurations too), the request of 100
   through the symbolic-batch artifact and the live model in turns, the
   training
   step and epoch of each model, and torch.profiler breakdowns of one
   request and one training step;
10. vectorized (seed-parallel runs, ``train/vectorized.py``, SEEDS = 5):
   each kernel with the seed axis folded in (the dot-graph mask (5, N, N),
   W_hh (5, 2, H, 4H), the attention's bias (5,) and adjacency) at the
   five seeds' shapes, against its plain version, one launch a call, and
   each group's answer bit for bit against the ungrouped kernel's on its
   slice where both take one plan (:func:`_grouped_vs_plain`), and timed;
   the keyed dropout mask of one key bit for bit on the CPU and the card;
   for FC_STGNN, LOGO, STAGNN, STFA, HAGCN, LOGO_bearing and GRU_CM a
   VectorizedEngine of 5 seeds against 5 sequential Engines from the same
   seeds, 5 steps at batch 100 (each seed its own permutation, dropout
   on at the bank's rates, each seed its sequential run's keyed masks):
   the launches of the steps and of an eval forward counted after a
   reset (one a call for all seeds; cuDNN's LSTM and GRU a call a seed),
   each seed's losses and parameters held (HAGCN: each term of its
   gradient at every step, the vectorized run's top-k selections replayed
   in the sequential ones; FC_STGNN: each term of its gradient at every
   step, the vectorized run's (leaky) ReLU masks replayed, and its
   losses); one vectorized epoch of FD001's
   (FEMTO's) real size against 5 sequential epochs (5 times one
   timed), samples/s over all
   seeds, and the card's busy share of a traced vectorized step;
11. bf16 (``--precision bf16``): each kernel's bf16 instantiation against
   its plain bf16 version (within one bf16 ulp) and against its own fp32
   instantiation on the up-cast inputs (within 2^-8 |ref|; the LSTM
   backward, recomputing from its stored bf16 trajectory, within 2^-8
   |ref| + 2^-5 max |ref|) at FC_STGNN's, LOGO's, HAGCN's, LOGO_bearing's,
   STAGNN's and STFA's shapes and a G = 5 case each; whether cuDNN takes a
   bf16 LSTM; FC_STGNN, LOGO and STAGNN 5 bf16 steps on the card against
   the CPU and one FD001 epoch through ``cli.main --precision bf16`` (the
   fp32 epoch's launches, every one bf16; fp32 parameters, Adam and
   BatchNorm statistics); bf16 serving of every method on a kernel at 100
   and 1000 against fp32; FC_STGNN's bf16 artifact against the live bf16
   model; each kernel's bf16 and fp32 times in turns, its bf16 bound, the
   plain bf16 version and cuDNN's bf16 LSTM; bf16 and fp32 training steps
   and epochs in turns;
12. resume: FC_STGNN (2,000 FD001 windows) and LOGO_bearing (400 PHM2012
   windows, across its MultiStepLR's milestone 10), dropout on, 3 epochs
   straight against 2 epochs, a ``checkpoint_every=1`` save, a new
   ``Trainer`` and ``resume=True``: parameters and predictions held at the
   5-step tolerances, bit-equal tensors counted; how long an
   ``AsyncCheckpointer.save`` blocks the training thread, and that the
   step after a save never reaches its file;
13. mesh (``--mesh``, ``parallel/``): a job of two ranks on this one card
   (``GNNRUL_*``, ``parallel/_dist_worker.py::launch``; gloo by the backend
   rule, NCCL taking one rank a device), :func:`_mesh_rank`:
   ``cli.main --mesh data=2`` trains FC_STGNN and LOGO 2 epochs on 2,000
   FD001 windows, each kernel's launches counted on each rank (the same as
   one process's: every step still launches), every step's loss and
   summed gradient held at the job's weights against one process's (FC_STGNN's
   (leaky) ReLU masks replayed, SIGNED), the free-running runs' drift
   printed; rank 0's final weights evaluated over the data axis
   (``--eval_torch_checkpoint --mesh data=2``) against one process, the
   predictions at MESH_PRED_ATOL and each rank the whole vector's metrics;
   rank 1 writes nothing; FC_STGNN trained 1
   epoch and resumed to 2 lands on the straight run; on ``data=1,
   model=2`` the four node-sharded engines at HierCorrPool's, STFA's and
   FC_STGNN's full-width shapes, forward and gradients, against the local
   computation on the card, and one FC_STGNN step through its hook against
   the step without it; ``cli.main --mesh data=1,model=2`` trains HAGCN
   at the bank's widths 2 epochs on 300 FD001 windows, its second Bi-LSTM's
   four weights split over the two ranks (tensor parallelism,
   ``parallel/model_axis.py``), :func:`_mesh_tp`: each rank's kernel #4/#5
   launches those of one process, each rank's bytes of the split weights
   and their Adam moments half the whole, every step's loss and whole
   gradient held at the job's weights against one process's (the job's
   top-k selections replayed), rank 0's checkpoint whole, its predictions
   over the model axis against one process's at MESH_PRED_ATOL, the run
   resumed after epoch 1 on the straight one; ``--profile`` of FC_STGNN's
   epoch 2 (rank 0) names
   ``fused_dot_graph_spmm``, its ten longest device operations printed;
   ``complexity_computation`` of FC_STGNN equal on the card and the CPU.

The line before the last is one JSON object ``{"kernels": [...]}`` (ten
entries, the five kernels at fp32 and at bf16; the grouped kernels' times
and the vectorized launches beside each fp32 one), the ones before it
``{"resume": {...}}`` (phase 12), ``{"mesh": {...}}`` (phase 13),
``{"vectorized": {...}}`` (phase 10's epochs) and ``{"bf16_train":
{...}}`` (phase 11's step and epoch ratios); the last line is ``{"ok":
true, "device": {...}}``.

``python3 -c "import chip_smoke as c; c._turns('build/parent')"`` times
the dot-graph forward and backward and the attention of an earlier commit
unpacked at ``build/parent`` and of this tree in turns on one card;
``c._turns('build/parent', c._HOST_TURN)`` the training steps and requests
of 100, ``c._LSTM_TURN`` the LSTM kernels, and ``c._DIGEST_TURN`` prints
digests of the fp32 kernels' outputs, for the two trees' to be compared.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import json
import os
import re
import runpy
import statistics
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from gnn_rul_tpu_torch import cli
from gnn_rul_tpu_torch.configs.data_configs import get_dataset_config
from gnn_rul_tpu_torch.configs.hparams import model_hparams, train_params
from gnn_rul_tpu_torch.data import phm2012
from gnn_rul_tpu_torch.data.io import load_processed, save_processed
from gnn_rul_tpu_torch import export
from gnn_rul_tpu_torch.export import build_model, serving_model
from gnn_rul_tpu_torch.models import fc_stgnn, gdagdl, hagcn, stgnn, stnet
from gnn_rul_tpu_torch.models.gat_lstm import path_graph
from gnn_rul_tpu_torch.models.stfa import prior_knowledge_graph
from gnn_rul_tpu_torch.nn import attention, recurrent
from gnn_rul_tpu_torch.nn.basic import dropout_key, step_key
from gnn_rul_tpu_torch.ops.graphs import covariance_threshold_graph
from gnn_rul_tpu_torch.ops.kernels import (WRAPPERS, build, fused_gat,
                                           keyed_dropout,
                                           fused_gnn, fused_lstm)
from gnn_rul_tpu_torch.ops.windows import decay_mask
from gnn_rul_tpu_torch.signal import features
from gnn_rul_tpu_torch.train.algorithms import get_algorithm_spec
from gnn_rul_tpu_torch.train.engine import GAMMA, MILESTONES, Engine
from gnn_rul_tpu_torch.train.vectorized import VectorizedEngine

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12     # H100 SXM fp32 outside the tensor cores
BF16_FLOP_PER_S = 989e12    # H100 SXM bf16 dense (tensor cores)
TOL_ATOL, TOL_RTOL = 1e-5, 1e-4          # kernel vs plain, both fp32
SERVE_ATOL, SERVE_RTOL = 2e-4, 1e-4      # card vs CPU, whole model
# artifact vs live model, both on the card: tests/test_export.py:52
ARTIFACT_ATOL, ARTIFACT_RTOL = 1e-5, 1e-5
SERVE_BATCH = 100                        # FD001 batch_size (hparams.py)
# card vs CPU over training steps: tests/test_parity_training.py:82-96
LOSS_RTOL, LOSS_ATOL, PARAM_MAX_DIFF = 2e-4, 2e-5, 5e-4
PARITY_STEPS = 5
# LOGO_bearing's parity steps cross its MultiStepLR's first milestone (5),
# as tests/test_parity_aux_losses.py's 7 do.
PARITY_STEPS_OF = {"LOGO_bearing": 7}
# FD001 at its real size: 100 engines, 20,631 rows, windows of 50 at
# stride 1 -> 15,731 training windows; one test window per engine.
FD001_ENGINES, FD001_ROWS, WINDOW, MAX_RUL = 100, 20631, 50, 125
SMI = ""  # nvidia-smi's name and power limit, beside every time printed
LSTM_BWD_KERNELS = ("lstm_gates_kernel", "lstm_sweep_kernel",
                    "lstm_dw_partial_kernel", "lstm_dw_reduce_kernel")
OUR_KERNELS = ("fwd_graph_kernel", "fwd_rows_kernel", "bwd_graph_kernel",
               "bwd_rows_kernel", "bwd_cols_kernel", "lstm_fwd_kernel",
               *LSTM_BWD_KERNELS, "fused_gat_kernel", "keyed_dropout_kernel")
# B at which the LSTM plans' thresholds in H are found (HAGCN's B = 5 plans
# as 3 does, widening every cluster to 8; at LOGO's 70 none widens), and H
# at which those in B are (HAGCN's 120, LOGO FD003's 192), B up to
# MAX_HIDDEN.
THRESHOLD_BS, THRESHOLD_HS = (3, 70), (120, 192)
# B at which the plan takes a cluster of 8, 4 and 2 CTAs at H = 120 on an
# H100's 132 SMs (fused_lstm.cuh, pick_plan), timed per step.
CLUSTER_BS = (5, 9, 17)
# The ported methods: the four of the kernels' slices, HAGCN (its Bi-LSTM on
# the recurrence kernels), the seven aero-engine methods that reach no port
# kernel, then the nine bearing methods: six that reach none either, then
# GAT_LSTM and GDAGDL (the graph attention) and LOGO_bearing (the
# recurrence).
BEARING_METHODS = ("HierCorrPool_bearing", "ST_GCN", "SAGCN", "AGCN_TF",
                   "STMSGCN", "STNet", "GAT_LSTM", "GDAGDL", "LOGO_bearing")
METHODS = ("FC_STGNN", "LOGO", "STAGNN", "STFA", "HAGCN", "RGCNU", "GRU_CM",
           "STGNN", "DVGTformer", "HierCorrPool", "ASTGCNN",
           "ST_Conv") + BEARING_METHODS
# The (dataset, dataset_id) each method runs at: C-MAPSS FD001, windows of
# (14, 50); the bearing methods PHM2012's Condition_1 (FEMTO), windows of
# (1, 2560), a vibration snapshot.
CELL = {m: (("PHM2012", "Condition_1") if m in BEARING_METHODS
            else ("CMAPSS", "FD001")) for m in METHODS}
# The benchmark tiers served at their own configurations (BASELINE.md tiers
# 3 to 5): (method, dataset, dataset_id, window length, None for the
# dataset config's). XJTU-SY's raw minute is 32,768 samples (64 patches of
# 512 in HierCorrPool_bearing's hparams, 32 of 1024 in LOGO_bearing's); the
# config's 30,768 is the reference's stale value. Tier 4's GAT_LSTM has no
# N-CMAPSS configuration in the hparam bank, so it is not served.
TIERS = (("HierCorrPool", "CMAPSS", "FD004", None),
         ("DVGTformer", "NCMAPSS", None, None),
         ("HierCorrPool_bearing", "XJTU_SY", "Condition_1", 32768),
         ("LOGO_bearing", "XJTU_SY", "Condition_1", 32768))
# FEMTO's PHM2012 Condition_1 at its real size: the acc files of each
# bearing (Bearing1_1 and 1_2 train, the other five test).
PHM_C1_FILES = {"Bearing1_1": 2803, "Bearing1_2": 871, "Bearing1_3": 1802,
                "Bearing1_4": 1139, "Bearing1_5": 2302, "Bearing1_6": 2302,
                "Bearing1_7": 1502}
SIGNAL_LENGTH = 2560  # a FEMTO snapshot: 0.1 s at 25.6 kHz


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
_GAT_LSTM_HP = model_hparams("PHM2012", "Condition_1", "GAT_LSTM")
_GDAGDL_HP = model_hparams("PHM2012", "Condition_1", "GDAGDL")
# The dot-graph chain runs once per scale, the LSTM recurrence once per
# Bi-LSTM layer, the graph attention once per head: STAGNN's two GAT layers
# of 3 heads, STFA's 10 heads, GAT_LSTM's and GDAGDL's 3 layers of one.
# STFA's, GAT_LSTM's (0.2) and GDAGDL's (0.5) attention dropout sends their
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
    # GAT_LSTM's 3 layers on the shared (40, 40) path graph, GDAGDL's on
    # B x 128 graphs of its 3 frequency bins.
    "GAT_LSTM": Path(fused_gat.fused_gat, "fused_gat",
                     len(_GAT_LSTM_HP["hidden_dim"]), 0,
                     0 if _GAT_LSTM_HP["dropout"] > 0
                     else len(_GAT_LSTM_HP["hidden_dim"])),
    "GDAGDL": Path(fused_gat.fused_gat, "fused_gat",
                   len(_GDAGDL_HP["gat_layer_dim"]), 0,
                   0 if gdagdl.ATTENTION_DROPOUT > 0
                   else len(_GDAGDL_HP["gat_layer_dim"])),
    # LOGO's trunk: T = the batch, B = 5 bins x 40 patches, H = 30, 60, 30.
    "LOGO_bearing": Path(fused_lstm.lstm_recurrence, "lstm_recurrence", 3,
                         fused_lstm.BWD_LAUNCHES_PER_CALL, 3),
}
NO_KERNEL = Path(None, None, 0, 0, 0)


def _path(method: str) -> Path:
    return KERNEL_OF.get(method, NO_KERNEL)


def _reset() -> None:
    """Every wrapper's counts to 0, before a main path is driven."""
    for kernel in (*WRAPPERS.values(), keyed_dropout.keyed_dropout):
        kernel.launches = kernel.bf16_launches = 0
        if hasattr(kernel, "launches_by_step"):
            kernel.launches_by_step = dict.fromkeys(kernel.launches_by_step,
                                                    0)
        if hasattr(kernel, "bwd_launches"):
            kernel.bwd_launches = kernel.bf16_bwd_launches = 0
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


def _windows(dataset: str, rng, n: int, seq_len=None) -> np.ndarray:
    """``n`` seeded windows of ``dataset``: unit-normal sensor readings for
    C-MAPSS and N-CMAPSS, min-max scaled vibration signals (uniform in [0,
    1)) for the bearing datasets."""
    cfg = get_dataset_config(dataset)
    shape = (n, cfg.input_channels, int(seq_len or cfg.sequence_len))
    draw = rng.uniform if dataset in ("PHM2012", "XJTU_SY") else rng.normal
    return draw(size=shape).astype(np.float32)


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
                  f"shared memory"
                  + (f", {p['step']} step" if "step" in p else ""))


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
    """(B, N, D, adjacency, bias, slope) on each side of every point at
    which the attention kernel's plan (graphs a block, blocks a graph, wh
    in chunks or whole) changes: in B at STFA's (N, D) = (14, 5) up to
    B = 1,400 (10 graphs a block from B = 1,320) and at STAGNN's (14, 64) up
    to B = 700 (2 graphs a block from B = 264), in N at B = 140 and D = 16 up to N = 160 (past where a whole graph stops
    fitting the block), in D at B = 1 and N = 41 up to D = 400 (past where
    wh goes in chunks)."""
    cases = set()
    for shape_of, top, adj in (
            (lambda v: (v, 14, 5), 1400, "shared"),
            (lambda v: (v, 14, 64), 700, "per-graph"),
            (lambda v: (140, v, 16), 160, "per-graph"),
            (lambda v: (1, 41, v), 400, "shared")):
        keys = [_gat_key(*shape_of(v)) for v in range(1, top + 1)]
        for v in range(2, top + 1):
            if keys[v - 1] != keys[v - 2]:
                cases.update((*shape_of(u), adj, 0.3, 0.1)
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
# W_hh beyond one CTA's shared memory (H = 192), LOGO_bearing's trunk at
# XJTU-SY (T = 100, B = 17 x 32 = 544, H = 30) and at PHM2012 (B = 5 x 40 =
# 200, H = 30 and 60), ragged shapes, the H limit (1024).
LSTM_CASES = [(100, 70, 24), (100, 70, 48), (31, 70, 24), (1000, 70, 48),
              (1400, 5, 60), (1400, 5, 120), (100, 70, 192), (100, 544, 30),
              (7, 13, 30), (1, 1, 8), (5, 3, 1024), (100, 200, 30),
              (100, 200, 60)]


@functools.cache
def _lstm_threshold_cases():
    """(6, B, H) on each side of every point at which the forward's or the
    backward sweep's plan (lanes per unit, cluster size, where W_hh sits,
    rows per lane, the forward's step) changes on this card: one H on each
    side at each B of THRESHOLD_BS, one B on each side at each H of
    THRESHOLD_HS."""
    kernel = fused_lstm.lstm_recurrence

    def key(h, b):
        plans = (kernel.plan(h, b, backward) for backward in (False, True))
        return tuple((p["lanes"], p["cluster"], p["w_mode"],
                      p["iters"] if p["w_mode"] == 2 else 0,
                      p.get("step")) for p in plans)

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


# (B, N, D, adjacency, bias, slope) of the graph attention, the adjacency
# one of _gat_inputs': STAGNN's serving shapes (per-graph covariance
# graphs), STFA's (B x 25 patch graphs on the shared prior graph: 2500 at
# batch 100, 25,000 for a request of 1000), N = 17 at D = 300, ragged
# shapes, a negative bias at slope 0.01, and a negative slope (the kernel
# takes each row's max over its logits, not through f2's); GAT_LSTM's first
# layer at batch 100 (the shared (40, 40) path graph), GDAGDL's (B x 128
# patch graphs of 3 bins, joined where a seeded importance is above 0, so
# some rows and some whole graphs are 0), and graphs with zero rows and
# whole zero graphs at both plans (row tiles, whole graphs a block).
GAT_CASES = [(100, 14, 64, "per-graph", 0.3, 0.1),
             (1000, 14, 64, "per-graph", 0.3, 0.1),
             (2500, 14, 5, "shared", 0.3, 0.1),
             (25000, 14, 5, "shared", 0.3, 0.1),
             (3, 17, 300, "per-graph", 0.3, 0.1),
             (1, 1, 1, "per-graph", 0.3, 0.1), (5, 33, 7, "shared", 0.3, 0.1),
             (2, 130, 16, "per-graph", 0.3, 0.1),
             (7, 33, 40, "per-graph", -0.4, 0.01),
             (300, 14, 64, "per-graph", 0.2, -0.3),
             (100, 40, 300, "path", 0.3, 0.1),
             (12800, 3, 300, "importance", 0.3, 0.1),
             (7, 17, 64, "zero-rows", 0.3, 0.1),
             (300, 3, 50, "zero-rows", -0.2, 0.1)]
def _gat_inputs(b: int, n: int, d: int, adj: str, bias: float, seed: int):
    """Seeded attention inputs on the card: unit-normal wh, f1 and f2
    (logits of unit scale, as a Linear projection gives) and the adjacency
    ``adj``: "per-graph", a random 0/1 graph a window with its diagonal
    set (a covariance graph's variances); "shared", one (N, N) for every
    graph (STFA's prior graph at N = 14, else random); "path", GAT_LSTM's
    path graph; "importance", GDAGDL's outer product of (importance > 0) a
    graph; "zero-rows", the same with every node of the first third of the
    graphs below 0."""
    rng = np.random.default_rng(seed)
    wh = rng.normal(size=(b, n, d))
    f1 = rng.normal(size=(b, n))
    f2 = rng.normal(size=(b, n))
    if adj == "per-graph":
        a = (rng.uniform(size=(b, n, n)) > 0.5).astype(np.float64)
        a[:, np.arange(n), np.arange(n)] = 1.0
    elif adj == "shared":
        a = (prior_knowledge_graph().numpy() if n == 14 else
             (rng.uniform(size=(n, n)) > 0.5).astype(np.float64))
    elif adj == "path":
        a = path_graph(n).numpy()
    else:
        importance = rng.normal(size=(b, n))
        if adj == "zero-rows":
            importance[: b // 3] = -np.abs(importance[: b // 3])
        high = (importance > gdagdl.THRESHOLD).astype(np.float64)
        a = high[:, :, None] * high[:, None, :]
    return tuple(torch.as_tensor(t, dtype=torch.float32).cuda().contiguous()
                 for t in (wh, f1, f2, a, np.float64(bias)))


def _gat_vs_plain() -> float:
    """The attention kernel against its plain version at GAT_CASES and on
    each side of its plan thresholds, by :func:`_hold`; where a row of the
    adjacency is all 0 (a node, or every node of a graph, below GDAGDL's
    threshold) the kernel's answer must be exactly 0, as the function's
    is."""
    kernel = fused_gat.fused_gat
    worst = 0.0
    for i, (b, n, d, adj, bias, slope) in enumerate(
            GAT_CASES + _gat_threshold_cases()):
        args = _gat_inputs(b, n, d, adj, bias, seed=300 + i)
        got = kernel(*args, slope)
        want = fused_gat.fused_gat_plain(*args, slope)
        torch.cuda.synchronize()
        what = (f"gat vs plain B={b} N={n} D={d} adj={adj} bias={bias} "
                f"slope={slope}")
        worst = max(worst, _hold(what, got, want, lambda: (
            fused_gat.fused_gat_plain(*(t.double() for t in args), slope))))
        zero = (args[3].sum(dim=-1) == 0).expand(b, n)
        if zero.any():
            off = got[zero].abs().max().item()
            print(f"{what}: {int(zero.sum())} all-zero adjacency rows "
                  f"({int((zero.sum(dim=-1) == n).sum())} whole graphs), the "
                  f"kernel's largest |answer| there {off}")
            if off != 0.0:
                raise AssertionError(f"{what}: a row without a neighbour "
                                     f"answers {off}, not 0")
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
def _plain_kernels():
    """The models' dot-graph chain, Bi-LSTM recurrence and graph attention
    on their plain versions, differentiable by autograd at any dtype, for
    an fp64 reference run (the registered operators take fp32 only)."""
    kept = (fc_stgnn.fused_dot_graph_spmm, recurrent.lstm_recurrence,
            attention.fused_gat)
    fc_stgnn.fused_dot_graph_spmm = fused_gnn.fused_dot_graph_spmm_plain
    recurrent.lstm_recurrence = fused_lstm.lstm_recurrence_plain
    attention.fused_gat = fused_gat.fused_gat_plain
    try:
        yield
    finally:
        (fc_stgnn.fused_dot_graph_spmm, recurrent.lstm_recurrence,
         attention.fused_gat) = kept


# The methods whose forward selects by top-k, and the function it selects
# with: HAGCN's SAGPool keeps a graph's k = 10, 5 and 1 nodes of highest
# score (the indices), STGNN keeps each row's top_k gaussian similarities
# (a 0/1 mask).
RANKED = {"HAGCN": (hagcn, "top_indices"), "STGNN": (stgnn, "topk_mask")}


# The methods whose held gradients (GRADIENT_HELD) are taken with the
# card's ReLU masks replayed on the CPU (:func:`_kinks`): HierCorrPool's
# encoder ReLUs follow train-mode BatchNorms, whose outputs cross 0 within
# the card's rounding (on an H100 80GB HBM3 at 700 W, one input to its
# third block's ReLU, 1.1e-7 from 0, took the other side on the card,
# which moved the conv3 weight gradient by 1.8e-5, above TOL). Over the 5
# free-running steps the masks are each side's own: the steps part the
# weights by up to the learning rate (GRADIENT_HELD), and the masks with
# them (by step 5 an input 4.8e-3 from 0 took another side).
# HierCorrPool_bearing runs the same encoder behind its STFT.
KINKED = ("HierCorrPool", "HierCorrPool_bearing")
# The methods whose forward selects frequency bins (SAGCN's and AGCN_TF's
# spectral features) and those that threshold a score (STNet's nodes above
# 0.7, GDAGDL's of importance above 0), with the module that holds the
# threshold (THRESHOLD, high_nodes), each replayed by :class:`_Replay`.
BINNED = ("SAGCN", "AGCN_TF")
BIN_SELECTIONS = ("median_bin", "peak_bin")
THRESHOLDED = {"STNet": stnet, "GDAGDL": gdagdl}


def _during(sel, mode: str):
    """``sel.record()`` or ``sel.replay()``; nothing for a method that
    replays no step function (``sel`` None)."""
    return getattr(sel, mode)() if sel else contextlib.nullcontext()


class _Call(NamedTuple):
    """A step function's call replayed on the CPU (:class:`_Replay`)."""
    name: str                 # the function's name
    x: torch.Tensor           # the CPU's input, on the host
    k: object                 # its int argument (top-k's k), else None
    own: torch.Tensor         # the CPU's own choice
    card: torch.Tensor        # the card's choice, which the CPU replayed
    card_x: object            # the card's input, where kept, else None


def _signature(args) -> tuple:
    return tuple(a.shape if torch.is_tensor(a) else a for a in args
                 if torch.is_tensor(a) or isinstance(a, int))


def _input(args) -> torch.Tensor:
    return next(a for a in args if torch.is_tensor(a))


def _as_input(chosen, *args):
    """The card's choice on the device of the call's input, a float choice
    (a mask) in its dtype."""
    x = _input(args)
    return chosen.to(x.device, x.dtype if chosen.is_floating_point()
                     else chosen.dtype)


@contextlib.contextmanager
def _patched(sites, make):
    """Replaces ``owner.<name>`` by ``make(name, owner.<name>)`` for each
    ``(owner, name)`` of ``sites`` inside the block."""
    kept = [(owner, name, getattr(owner, name)) for owner, name in sites]
    for owner, name, fn in kept:
        setattr(owner, name, make(name, fn))
    try:
        yield
    finally:
        for owner, name, fn in kept:
            setattr(owner, name, fn)


class _Replay:
    """The step functions of a method's forwards (top-k selections,
    frequency bins, threshold masks, ReLU masks): recorded as the card
    takes them, then replayed in the same order on the CPU (and in fp64),
    so that both sides compute one function. A step function's output
    jumps where its input crosses a boundary: where an input lies within
    rounding of one, the card and the CPU may choose otherwise and give
    answers that differ by more than any tolerance. The first replay also
    keeps the CPU's own choices; ``reporter(method, what, calls)`` prints
    the margins and the choices that differ between card and CPU, fails
    where they differ further from a boundary than rounding explains, and
    returns their count.

    Each ``owner.<name>`` of ``names`` is patched (each ``(owner, name)``
    of ``sites`` where given). ``choose(*args)`` is a call's choice where
    it is not the function's output (a ReLU's mask), and ``answer(choice,
    *args)`` what a replayed call returns (``answer[name]`` where a dict
    gives each function its own)."""

    def __init__(self, owner, names, reporter, choose=None,
                 answer=_as_input, card_inputs=False, sites=None):
        self.sites = sites or [(owner, name) for name in names]
        self.reporter = reporter
        self.choose, self.answer = choose, answer
        self.card_inputs = card_inputs
        self.card = []   # (name, signature, choice, input or None), per call
        self.cpu = []    # _Call, per call of the first replay

    @contextlib.contextmanager
    def _patched(self, make):
        with _patched(self.sites, make):
            yield

    def _choice(self, fn, args):
        return (fn(*args) if self.choose is None
                else self.choose(*args)).cpu()

    def record(self):
        def make(name, fn):
            def recorded(*args):
                out = fn(*args)
                chosen = out if self.choose is None else self.choose(*args)
                self.card.append((name, _signature(args), chosen.cpu(),
                                  _input(args).detach().cpu()
                                  if self.card_inputs else None))
                return out
            return recorded
        return self._patched(make)

    def replay(self):
        """Replays the card's choices from the first; keeps the CPU's own
        of the first replay."""
        it = iter(self.card)
        first = not self.cpu

        def make(name, fn):
            def replayed(*args):
                kind, signature, chosen, card_x = next(it)
                if kind != name or signature != _signature(args):
                    raise AssertionError("the CPU's forwards are not the "
                                         "card's")
                if first:
                    k = next((a for a in args if isinstance(a, int)), None)
                    self.cpu.append(_Call(name, _input(args).detach().cpu(),
                                          k, self._choice(fn, args), chosen,
                                          card_x))
                answer = (self.answer[name] if isinstance(self.answer, dict)
                          else self.answer)
                return answer(chosen, *args)
            return replayed
        return self._patched(make)

    def report(self, method: str, what: str) -> int:
        if len(self.card) != len(self.cpu):
            raise AssertionError(f"{len(self.card)} calls on the card, "
                                 f"{len(self.cpu)} replayed")
        return self.reporter(method, what, self.cpu)


def _report_kinks(method: str, what: str, calls) -> int:
    """Prints the ReLU inputs whose mask differs between card and CPU and
    the largest |input| among them; fails where such an input lies further
    than TOL_ATOL from 0 on the CPU."""
    entries = differ = 0
    far = 0.0
    where = set()
    for c in calls:
        flipped = c.own != c.card
        entries += c.own.numel()
        differ += int(flipped.sum())
        if flipped.any():
            far = max(far, c.x[flipped].abs().max().item())
            where.add(c.name)
    print(f"relu {method} {what}: {entries} inputs, {differ} masks differ "
          f"between card and CPU"
          + (f" (in {', '.join(sorted(where))}), the largest |input| among "
             f"them {far:.3e}" if differ else "")
          + "; the CPU replays the card's masks")
    if far > TOL_ATOL:
        raise AssertionError(f"{method}: a ReLU input {far} from 0 takes "
                             f"another side on the card")
    return differ


def _report_ranks(method: str, what: str, calls) -> int:
    """Prints the smallest gap between the k-th and (k+1)-th score of every
    row ranked on the CPU and the selections that differ between card and
    CPU (graphs whose kept nodes differ, or mask entries). Fails where a
    node kept on one side and not on the other (or a mask entry that
    differs) scores, on the CPU, further than the kernels' relative
    tolerance from its row's k-th score."""
    rows = ties = differ = 0
    gap_min = rel_min = float("inf")
    rel_differ = 0.0
    for c in calls:
        # Every k here is below the row length N (k = 10, 5, 1 of 14, 10,
        # 5 nodes; 10 of 14).
        k = c.k
        scores = c.x.double().reshape(-1, c.x.shape[-1])
        if c.own.dtype == torch.long:         # indices: compare as sets
            kept = [torch.zeros(scores.shape, dtype=torch.bool).scatter(
                1, s.reshape(-1, k), True) for s in (c.own, c.card)]
            swapped = kept[0] ^ kept[1]
            differ += int(swapped.any(-1).sum())
        else:                                 # masks: count entries
            swapped = (c.own != c.card).reshape(scores.shape)
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


def _report_bins(method: str, what: str, calls) -> int:
    """Prints, per kind of bin, the rows ranked, those whose chosen value
    another bin of the row equals exactly (a mirror pair), the smallest
    nonzero relative gap between a chosen value and any other of its row,
    and the bins that differ between card and CPU. Fails where the CPU's
    values at the card's bin and at its own differ by more than TOL_RTOL
    relative."""
    differ = 0
    for kind in BIN_SELECTIONS:
        rows = ties = kind_differ = 0
        gap_min, rel_differ = float("inf"), 0.0
        for c in calls:
            if c.name != kind:
                continue
            v = c.x.double().reshape(-1, c.x.shape[-1])
            own, card = c.own.reshape(-1), c.card.reshape(-1)
            at = v.gather(1, own[:, None])
            gap = (v - at).abs() / at.abs().clamp(min=1e-300)
            gap.scatter_(1, own[:, None], float("inf"))
            rows += v.shape[0]
            ties += int((gap == 0).any(-1).sum())
            if (gap > 0).any():
                gap_min = min(gap_min, gap[gap > 0].min().item())
            flipped = own != card
            kind_differ += int(flipped.sum())
            if flipped.any():
                theirs = v.gather(1, card[:, None])
                rel_differ = max(rel_differ, ((at - theirs).abs()
                                              / at.abs())[flipped]
                                 .max().item())
        print(f"bins {method} {what}: {kind} of {rows} rows, {ties} on a "
              f"value another bin of the row equals exactly, smallest "
              f"nonzero relative gap to another bin {gap_min:.3e}; "
              f"{kind_differ} differ between card and CPU"
              + (f", their values at most {rel_differ:.3e} relative "
                 f"apart" if kind_differ else "")
              + f"; the CPU replays the card's {len(calls)} selections")
        if rel_differ > TOL_RTOL:
            raise AssertionError(f"{method}: a {kind} differs between "
                                 f"card and CPU on values {rel_differ} "
                                 f"relative apart, above {TOL_RTOL}")
        differ += kind_differ
    return differ


def _report_masks(method: str, what: str, calls) -> int:
    """Prints the smallest |score - threshold| and the node-mask entries
    that differ between card and CPU; fails unless the threshold lies
    between the card's score and the CPU's at each."""
    threshold = THRESHOLDED[method].THRESHOLD
    entries = differ = 0
    margin, apart = float("inf"), 0.0
    for c in calls:
        scores, card_scores = c.x.double(), c.card_x.double()
        entries += c.own.numel()
        margin = min(margin, (scores - threshold).abs().min().item())
        flipped = c.own != c.card
        differ += int(flipped.sum())
        if flipped.any():
            lo = torch.minimum(scores, card_scores)[flipped]
            hi = torch.maximum(scores, card_scores)[flipped]
            if not bool(((lo <= threshold) & (threshold <= hi)).all()):
                raise AssertionError(f"{method}: a node mask differs where "
                                     f"both scores lie on one side of "
                                     f"{threshold}")
            apart = max(apart, (hi - lo).max().item())
    print(f"threshold {method} {what}: {entries} node scores, smallest "
          f"|score - {threshold}| {margin:.3e}; {differ} masks "
          f"differ between card and CPU"
          + (f", card and CPU scores at most {apart:.3e} apart there"
             if differ else "")
          + f"; the CPU replays the card's {len(calls)} masks")
    return differ


def _kinks() -> _Replay:
    """The masks ``x > 0`` of every ``nn.ReLU`` of a kinked method's
    forwards, replayed on the CPU as ``x * mask``: ReLU's gradient is a step
    function of its input, so where an input lies within rounding of 0,
    the card and the CPU may pass or stop that element's whole gradient."""
    return _Replay(torch.nn.ReLU, ("forward",), _report_kinks,
                   choose=lambda module, x: x > 0,
                   answer=lambda mask, module, x:
                   x * mask.to(x.device, x.dtype))


def _sloped(slope: float):
    """The replayed answer of a (leaky) ReLU of ``slope``: ``x`` where the
    recorded mask is set, else ``slope * x``, and the gradient so."""
    def answer(mask, *args):
        x = _input(args)
        return torch.where(mask.to(x.device), x, x * slope)
    return answer


# The (leaky) ReLUs of a method's forward whose masks a vectorized run
# records and each seed's sequential run replays where its gradient is
# held (:func:`_hold_vectorized_gradients`), with their negative slope:
# FC_STGNN's encoder ReLUs (nn.ReLU and its head's torch.relu call
# torch.relu) follow train-mode BatchNorms over 3.0M inputs a seed, and
# its MPNN's leaky_relu a train-mode BatchNorm; an input within rounding
# of 0 takes one side in the vectorized run's batched products and the
# other in the sequential run's, which moves a weight gradient ahead of
# it by more than TOL (as HierCorrPool's, KINKED). The dot graph's own
# leaky_relu lies inside its kernel and is not replayed.
SIGNED = {"FC_STGNN": ((torch, "relu", 0.0), (fc_stgnn, "leaky_relu",
                                              0.01))}


def _signs(method: str) -> _Replay:
    """The recorder of ``method``'s (leaky) ReLU masks (SIGNED), replayed
    as :func:`_sloped`."""
    sites = SIGNED[method]
    return _Replay(None, (), _report_kinks,
                   choose=lambda *args: _input(args) > 0,
                   answer={name: _sloped(slope) for _, name, slope in sites},
                   sites=[(owner, name) for owner, name, _ in sites])


def _replayer(method: str):
    """The recorder of ``method``'s step functions as the card takes them,
    which the CPU then replays: top-k selections, frequency bins or node
    masks; None for a method without one."""
    if method in RANKED:
        module, name = RANKED[method]
        return _Replay(module, (name,), _report_ranks)
    if method in BINNED:
        return _Replay(features, BIN_SELECTIONS, _report_bins)
    if method in THRESHOLDED:
        return _Replay(THRESHOLDED[method], ("high_nodes",), _report_masks,
                       card_inputs=True)
    return None


def _seeded_state_dict(method: str = "FC_STGNN", seed: int = 0,
                       dataset=None, dataset_id=None):
    """``method`` weights at ``(dataset, dataset_id)`` (its CELL's where
    not given) from ``seed``, with any BN running statistics set away from
    (0, 1) so that eval-mode BN is not the identity."""
    if dataset is None:
        dataset, dataset_id = CELL[method]
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
    dataset, dataset_id = CELL[method]
    sd = _seeded_state_dict(method)
    models = {bs: {dev: serving_model(method, dataset, dataset_id, sd,
                                      batch_size=bs, device=dev)
                   for dev in ("cuda", "cpu")}
              for bs in (SERVE_BATCH, None)}
    rng = np.random.default_rng(1)
    requests = [(SERVE_BATCH, _windows(dataset, rng, n))
                for n in [SERVE_BATCH] * 5 + [37]]
    requests.append((None, _windows(dataset, rng, 1000)))
    forwards = sum(-(-len(x) // (bs or len(x))) for bs, x in requests)

    sel = _replayer(method)
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
    against the CPU at the same batch; the method's kernel launches its
    count a forward, and no other wrapper counts a launch. Returns
    {"<method> <dataset>/<dataset_id>": (fixed, symbolic, x100, x1000,
    launches)}."""
    out = {}
    for method, dataset, dataset_id, seq_len in TIERS:
        sd = _seeded_state_dict(method, 0, dataset, dataset_id)
        models = {bs: {dev: serving_model(method, dataset, dataset_id, sd,
                                          batch_size=bs, seq_len=seq_len,
                                          device=dev)
                       for dev in ("cuda", "cpu")}
                  for bs in (SERVE_BATCH, None)}
        rng = np.random.default_rng(4)
        requests = [(bs, _windows(dataset, rng, n, seq_len))
                    for bs, n in ((SERVE_BATCH, SERVE_BATCH), (None, 1000))]
        channels, length = requests[0][1].shape[1:]
        path = _path(method)
        _reset()
        answers = [models[bs]["cuda"](x) for bs, x in requests]
        torch.cuda.synchronize()
        launches = _counts(path.kernel)[0]
        _only_its_kernel(method, f"serve {dataset}/{dataset_id}")
        if launches != path.per_forward * len(requests):
            raise AssertionError(f"expected {path.per_forward} launches per "
                                 f"forward, got {launches} for "
                                 f"{len(requests)}")
        worst = 0.0
        for (bs, x), got in zip(requests, answers):
            want = models[bs]["cpu"](x)
            if got.shape != (len(x),) or not np.isfinite(got).all():
                raise AssertionError(f"serving answer of shape {got.shape} "
                                     f"for {len(x)} rows, or not finite")
            np.testing.assert_allclose(got, want, atol=SERVE_ATOL,
                                       rtol=SERVE_RTOL)
            worst = max(worst, float(np.abs(got - want).max()))
        name = (type(path.kernel).__name__ if path.kernel
                else "no port kernel,")
        print(f"serve {method} {dataset}/{dataset_id}: requests of "
              f"{SERVE_BATCH} and 1000 of ({channels}, {length}) windows "
              f"({requests[1][1].nbytes} bytes the larger), {name} "
              f"launches={launches}; every answer matches the CPU, max "
              f"|diff| {worst:.3e} (atol={SERVE_ATOL}, rtol={SERVE_RTOL})")
        out[f"{method} {dataset}/{dataset_id}"] = (
            models[SERVE_BATCH]["cuda"], models[None]["cuda"],
            requests[0][1], requests[1][1], launches)
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
        meta, program = export.export_serving(method, *CELL[method], sd,
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
# replaying its top-k selections or ReLU masks). HierCorrPool_bearing holds
# its first step's only: at the CPU's second step's weights its squared
# error's gradient reaches 98 in the encoder's first convolution, and the
# CPU's own fp32 gradient misses the same in fp64 by 4.1e-5 on 50 values
# (the card's, at the card's weights, by 8.0e-5 on an H100 80GB HBM3 at
# 700 W), as HAGCN's does past its first step.
# STNet's steps at the bank's lr 1e-2 run its losses from 0.62 to 28,092
# and back to 231 in 5 steps, and amplify the rounding of cuDNN's LSTM: its
# first-step gradient of the last Linear is 5.2e-6 off fp64 on the card
# against 3.2e-7 on the CPU (both within TOL), and after 5 steps the card's
# parameters end 9.4e-4 off fp64 whichever Adam runs them (foreach, loop:
# 9.4e-4; fused: 1.2e-3), the CPU's 1.4e-4 to 2.3e-4 at 1 to 8 threads (on
# an H100 80GB HBM3 at 700 W and its host). Its gradient is held at each
# step's weights as the card trains, on cuDNN, with the card's node masks
# replayed; its free-running steps, held as any method's, run on the card
# without cuDNN (CUDNN_OFF), where its parameters end 1.1e-4 from the
# CPU's (on cuDNN 9.4e-4 from fp64; on an H100 80GB HBM3 at 700 W).
# GAT_LSTM's first attention layer keeps its logits f1_i + f2_j + b on one
# side of 0 along nearly every row (its statistics' kurtosis, up to ~500,
# dominates wh), where the leaky_relu is linear and f1_i cancels in the
# row's softmax: the gradient of that half of its att_kernel comes from
# the few rows that cross 0, a step function of the weights, and on the
# CPU at batch 4 and lr 1e-3 (tests/test_torch_gat_bearing.py) no fp32 run
# holds it within PARAM_MAX_DIFF of fp64 after 5 steps (JAX's 2.0e-3, the
# port's 1.7e-3); its gradient is held at each step.
# A method's free-running parameters are held as any method's unless the
# CPU's own fp32 parameters miss fp64 by more than PARAM_MAX_DIFF too; then
# its losses are not held either where its gradient is held at every step.
GRADIENT_HELD = {"HAGCN": 1, "HierCorrPool": PARITY_STEPS,
                 "HierCorrPool_bearing": 1, "STNet": PARITY_STEPS,
                 "GAT_LSTM": PARITY_STEPS}
# The methods whose free-running parity steps run on the card with cuDNN
# off (torch's own CUDA LSTM), the steps on cuDNN printed against fp64.
CUDNN_OFF = ("STNet",)


@contextlib.contextmanager
def _cudnn(enabled: bool):
    kept = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = enabled
    try:
        yield
    finally:
        torch.backends.cudnn.enabled = kept


def _steps(engine: Engine, xs, ys, device: str, dtype=torch.float32,
           states=None, lrs=None):
    """A train step on ``engine`` for each batch; returns the losses. With a
    list ``states``, appends the model's state_dict (on the host) before
    each step; with a list ``lrs``, the lr each step runs at."""
    losses = []
    for x, y in zip(xs, ys):
        if states is not None:
            states.append({k: v.detach().cpu().clone()
                           for k, v in engine.model.state_dict().items()})
        if lrs is not None:
            lrs.append(engine.optimizer.param_groups[0]["lr"])
        losses.append(float(engine.train_step(
            torch.from_numpy(x).to(device, dtype),
            torch.from_numpy(y).to(device, dtype))))
    return np.array(losses)


def _term_gradients(model, x, y, device: str, dtype=torch.float32,
                    key=None):
    """``{term: the gradient of every parameter as one flat fp64 vector on
    the host}`` for each term of the model's training loss, the
    prediction's mean squared error and, for an auxiliary-loss model, the
    auxiliary term, at the model's weights on one batch; ``key`` keys its
    dropout (``nn/basic.py``; no dropout where the model has none)."""
    model = model.to(device, dtype).train()
    with dropout_key(0 if key is None else key):
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
    sel = _kinks() if method in KINKED else _replayer(method)
    with _during(sel, "record"):
        card = _term_gradients(seeded(), x, y, "cuda")
    with _during(sel, "replay"):
        cpu = _term_gradients(seeded(), x, y, "cpu")

    @functools.cache
    def exact():
        with _plain_kernels(), _during(sel, "replay"):
            return _term_gradients(seeded(torch.float64), x, y, "cpu",
                                   torch.float64)

    if sel:
        sel.report(method, f"the loss terms' gradients at step {step}")
    for term in card:
        _hold(f"train parity {method}: step {step}'s gradient of the {term} "
              f"term, card vs cpu ({card[term].numel()} values)",
              card[term], cpu[term], lambda term=term: exact()[term])


def _lrs(method: str, steps: int) -> list:
    """The lr of each of a run's first ``steps`` optimizer steps: the bank's
    lr, or for a method whose spec steps the per-batch MultiStepLR, the lr
    at step t (0-based) times GAMMA for each milestone up to t."""
    dataset, dataset_id = CELL[method]
    lr = float(train_params(dataset, dataset_id, method)["learning_rate"])
    multistep = get_algorithm_spec(method).per_batch_multistep
    return [lr * GAMMA ** (sum(m <= t for m in MILESTONES) if multistep
                           else 0) for t in range(steps)]


def _train_parity(method: str) -> None:
    """PARITY_STEPS steps (PARITY_STEPS_OF's where it names the method;
    their lrs printed and held to the schedule's) at batch 100 on the card
    and on the CPU from the
    same weights on the same batches, dropout off, cuDNN deterministic and
    without TF32 for this phase; a ranked method's CPU steps replay the
    card's top-k selections (:class:`_Replay`). Where the losses or the
    parameters miss, both sides are held against the same steps in fp64 on
    the CPU: the card within the same tolerance of them and the closer of
    the two. A method in CUDNN_OFF runs these card steps without cuDNN and
    prints how far its steps on cuDNN end from fp64. A method in
    GRADIENT_HELD also holds the gradient of each term of its loss at the
    weights of the card's first steps (on cuDNN), by :func:`_hold`."""
    torch.backends.cudnn.deterministic = True
    torch.manual_seed(0)
    dataset, dataset_id = CELL[method]
    sd = build_model(method, dataset, dataset_id).state_dict()

    def seeded(dtype=torch.float32):
        model = build_model(method, dataset, dataset_id)
        model.load_state_dict(sd)
        return _no_dropout(model.to(dtype))

    def engine(device, dtype=torch.float32):
        return Engine(seeded(dtype), get_algorithm_spec(method),
                      train_params(dataset, dataset_id, method),
                      device=device)

    engines = {device: engine(device) for device in ("cuda", "cpu")}
    steps = PARITY_STEPS_OF.get(method, PARITY_STEPS)
    rng = np.random.default_rng(2)
    xs = _windows(dataset, rng, steps * SERVE_BATCH)
    xs = xs.reshape(steps, SERVE_BATCH, *xs.shape[1:])
    ys = rng.uniform(size=(steps, SERVE_BATCH, 1)).astype(np.float32)

    path = _path(method)
    sel = _replayer(method)
    states = [] if method in GRADIENT_HELD else None
    cudnn_off = method in CUDNN_OFF
    lrs = []
    _reset()
    with _during(sel, "record"), _cudnn(not cudnn_off):
        card = _steps(engines["cuda"], xs, ys, "cuda",
                      states=None if cudnn_off else states, lrs=lrs)
    if cudnn_off:
        # The steps as the card trains, on cuDNN: the weights at which the
        # gradient is held, and their distance from fp64, printed.
        engines["cudnn"] = engine("cuda")
        card_cudnn = _steps(engines["cudnn"], xs, ys, "cuda", states=states)
    torch.cuda.synchronize()
    fwd_launches, bwd_launches = _counts(path.kernel)
    _only_its_kernel(method, "train parity")
    # Dropout is off here, so every training forward takes the kernel.
    want = (path.per_forward * steps,
            path.per_forward * path.bwd_per_call * steps)
    if (fwd_launches, bwd_launches) != want:
        raise AssertionError(f"expected (forward, backward) launches {want}, "
                             f"got {(fwd_launches, bwd_launches)}")
    if lrs != _lrs(method, steps):
        raise AssertionError(f"the steps ran at lrs {lrs}, not "
                             f"{_lrs(method, steps)}")
    with _during(sel, "replay"):
        cpu = _steps(engines["cpu"], xs, ys, "cpu")
    if sel:
        sel.report(method, f"{steps} training steps")
    for i, state in enumerate((states or [])[:GRADIENT_HELD.get(method)]):
        def at_step(dtype=torch.float32, state=state):
            model = build_model(method, dataset, dataset_id)
            model.load_state_dict(state)
            return _no_dropout(model.to(dtype))
        _hold_term_gradients(method, at_step, xs[i], ys[i], step=i + 1)
    torch.backends.cudnn.deterministic = False

    params = {dev: {k: p.detach().cpu().double() for k, p in
                    engines[dev].model.named_parameters()}
              for dev in engines}
    param_diff = max((p - params["cpu"][k]).abs().max().item()
                     for k, p in params["cuda"].items())
    print(f"train parity {method}: {steps} steps at batch "
          f"{SERVE_BATCH}, lrs {lrs}, losses card {card.tolist()} cpu "
          f"{cpu.tolist()}; max |param card - cpu| {param_diff:.3e}; "
          f"launches forward {fwd_launches}, backward {bwd_launches}")

    def exact():
        """The same steps in fp64 on the CPU: (losses, parameters)."""
        e64 = engine("cpu", torch.float64)
        with _plain_kernels(), _during(sel, "replay"):
            losses = _steps(e64, xs, ys, "cpu", torch.float64)
        return losses, {k: p.detach() for k, p in
                        e64.model.named_parameters()}

    loss_miss = not np.all(np.abs(card - cpu)
                           <= LOSS_ATOL + LOSS_RTOL * np.abs(cpu))
    param_miss = not param_diff < PARAM_MAX_DIFF
    if not (loss_miss or param_miss or cudnn_off):
        return
    losses64, params64 = exact()
    if cudnn_off:
        on, off_ = (max((p - params64[k]).abs().max().item()
                        for k, p in params[dev].items())
                    for dev in ("cudnn", "cuda"))
        print(f"train parity {method}: against the same steps in fp64 on "
              f"the CPU, the card's parameters on cuDNN are off by "
              f"{on:.3e} and its losses by "
              f"{float(np.abs(card_cudnn - losses64).max()):.3e}; without "
              f"cuDNN (the steps held here) by {off_:.3e} and "
              f"{float(np.abs(card - losses64).max()):.3e}")
        if not (loss_miss or param_miss):
            return
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
    every_step = GRADIENT_HELD.get(method) == steps
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


FD001_TEST_ROWS = 13096  # the rows of test_FD001.txt, 100 engines
# The 21 sensors' levels in FD001's files; the 7 the preprocessor drops
# (s1, s5, s6, s10, s16, s18, s19) are flat, the others drift with wear.
_FD001_LEVELS = (518.67, 642.0, 1585.0, 1400.0, 14.62, 21.61, 553.9,
                 2388.0, 9050.0, 1.3, 47.3, 521.7, 2388.0, 8130.0, 8.42,
                 0.03, 392.0, 2388.0, 100.0, 38.9, 23.3)
_FD001_FLAT = (0, 4, 5, 9, 15, 17, 18)


def _engine_lengths(rng, total: int, lo: int, hi: int) -> np.ndarray:
    """FD001_ENGINES lengths drawn in [lo, hi), scaled to sum to
    ``total``."""
    lengths = rng.integers(lo, hi, FD001_ENGINES)
    lengths = np.floor(lengths * total / lengths.sum()).astype(int)
    lengths[: total - lengths.sum()] += 1
    return lengths


class _Processed(NamedTuple):
    """A processed dataset on disk and in the loader's layout: the training
    windows and labels, the test windows per key (None for one test set,
    the bearing for PHM2012), the max RUL of the first test key, and the
    ``--data_path`` root."""
    train_x: np.ndarray
    train_y: np.ndarray
    tests: dict
    max_rul: float
    root: str


def _write_fd001(root: str, seed: int = 3) -> _Processed:
    """A synthetic processed FD001 at the real size, in the layout of the
    C-MAPSS preprocessor: per engine a [0, 1] sensor series, every window
    of 50 at stride 1 labelled with the capped RUL at its last row over
    MAX_RUL; one test window per engine."""
    rng = np.random.default_rng(seed)
    train_x, train_y, test_x, test_y = [], [], [], []
    for length in _engine_lengths(rng, FD001_ROWS, 128, 363):
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
    return _Processed(
        np.ascontiguousarray(train_x.transpose(0, 2, 1)), train_y,
        {None: np.stack(test_x).astype(np.float32).transpose(0, 2, 1)},
        MAX_RUL, os.path.join(root, "Processed_dataset"))


def _write_phm2012(root: str, seed: int = 7) -> _Processed:
    """A synthetic processed PHM2012 Condition_1 at FEMTO's real size, in
    the layout of the PHM2012 preprocessor: a snapshot of 2,560 samples per
    acc file (PHM_C1_FILES), min-max scaled; train the two training
    bearings' 3,674 snapshots, shuffled; test a dict of the five test
    bearings; labels ``(n - i + RUL_last)`` over their max, and
    ``max_ruls`` per bearing."""
    rng = np.random.default_rng(seed)
    split = phm2012.TRAIN_TEST_SPLIT
    x, y, max_ruls = {}, {}, {}
    for bearing, n in PHM_C1_FILES.items():
        # A vibration whose amplitude grows as the bearing wears.
        amp = np.linspace(0.05, 0.5, n, dtype=np.float32)[:, None]
        x[bearing] = np.clip(0.5 + amp * rng.standard_normal(
            (n, SIGNAL_LENGTH), dtype=np.float32), 0, 1)
        labels = n - np.arange(n) + phm2012.RUL_DICT[bearing]
        max_ruls[bearing] = float(labels.max())
        y[bearing] = (labels / labels.max()).astype(np.float32)
    train = split["Condition1_train"]
    perm = rng.permutation(sum(PHM_C1_FILES[b] for b in train))
    train_x = np.concatenate([x[b] for b in train])[perm]
    train_y = np.concatenate([y[b] for b in train])[perm]
    tests = {b: x[b] for b in split["Condition1_test"]}
    data_dir = os.path.join(root, "Processed_dataset", "PHM2012",
                            "Condition_1")
    save_processed(data_dir, "train", train_x, train_y, max_ruls)
    save_processed(data_dir, "test", tests,
                   {b: y[b] for b in tests}, max_ruls)
    first = split["Condition1_test"][0]
    return _Processed(train_x[:, None, :], train_y[:, None],
                      {b: v[:, None, :] for b, v in tests.items()},
                      max_ruls[first], os.path.join(root,
                                                    "Processed_dataset"))


def _results_rows(run_dir: str, key) -> list:
    """The rows of a run's results.csv (``<key>_results.csv`` for a key of
    a dict test set)."""
    tag = f"{key}_" if key is not None else ""
    with open(os.path.join(run_dir, f"{tag}results.csv")) as f:
        return [line.strip().split(",") for line in f if line.strip()]


# The keyed dropout kernel's launches over each method's epoch through
# cli.main (:func:`_train_entry_point`), and at bf16 (:func:`_bf16_epoch`).
DROPOUT_EPOCH: dict = {}
DROPOUT_EPOCH_BF16: dict = {}


def _train_entry_point(method: str, data: _Processed):
    """The main path: ``cli.main`` trains one epoch of ``method`` on the
    card; then ``cli.main --eval_torch_checkpoint`` evaluates the epoch's
    checkpoint.pt, whose metrics must be the trainer's own on every test
    set. Returns the kernel's (forward, backward) launches and its backward
    calls over the training run, and its launches over the evaluation."""
    dataset, dataset_id = CELL[method]
    save_dir = os.path.join(os.path.dirname(data.root), "logs")
    args = ["--GNN_method", method, "--dataset", dataset, "--dataset_id",
            dataset_id, "--data_path", data.root, "--save_dir", save_dir]
    path = _path(method)
    _reset()
    t0 = time.perf_counter()
    results = cli.main(args + ["--epochs", "1", "--num_runs", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    fwd_launches, bwd_launches = _counts(path.kernel)
    bwd_calls = getattr(path.kernel, "bwd_calls", 0)
    _only_its_kernel(method, "train entry point")
    DROPOUT_EPOCH[method] = _dropout_launches(
        method, "train entry point", -(-len(data.train_x) // SERVE_BATCH))

    run_dir = os.path.join(save_dir, "GNN_RUL", "run_1", f"{method}_run_0")
    with open(os.path.join(run_dir, "logs_run_0.log")) as f:
        losses = [float(v) for v in re.findall(r"loss\t: (\S+)", f.read())]
    best = results[0]
    n_test = sum(map(len, data.tests.values()))
    print(f"train entry point {method}: cli.main, 1 epoch of "
          f"{len(data.train_x)} windows on the card in {wall:.2f} s (build, "
          f"upload and evaluation of {n_test} test windows included); epoch "
          f"loss {losses}; best (Score_v1, Score_v2, MAE, RMSE) "
          f"{best if len(best) > 1 else best[None]}; launches forward "
          f"{fwd_launches}, backward {bwd_launches} in {bwd_calls} calls; "
          f"keyed dropout {DROPOUT_EPOCH[method]}")
    if len(losses) != 1 or not np.isfinite(losses[0]):
        raise AssertionError(f"epoch losses {losses}")
    if set(best) != set(data.tests):
        raise AssertionError(f"results for {sorted(best)}")
    for key in data.tests:
        rows = _results_rows(run_dir, key)
        if rows[0] != ["Score_v1", "Score_v2", "MAE", "RMSE"] \
                or len(rows) != 2 \
                or not np.isfinite([float(v) for v in rows[1]]).all():
            raise AssertionError(f"results.csv of {key} holds {rows}")
    steps = -(-len(data.train_x) // SERVE_BATCH)
    evals = sum(-(-len(x) // SERVE_BATCH) for x in data.tests.values())
    want = (path.train_per_forward * steps + path.per_forward * evals,
            path.train_per_forward * path.bwd_per_call * steps)
    if (fwd_launches, bwd_launches) != want:
        raise AssertionError(f"expected (forward, backward) launches {want}, "
                             f"got {(fwd_launches, bwd_launches)}")

    key, test_x = next(iter(data.tests.items()))
    if method == "STAGNN":
        _adjacency_margin("FD001 test windows", test_x)
    ckpt_path = os.path.join(run_dir, "checkpoint.pt")
    ckpt = torch.load(ckpt_path, map_location="cpu", weights_only=True)
    # The lr after the epoch's last step: a per-batch MultiStepLR's last
    # value, or the bank's lr.
    lr = ckpt["optimizer"]["param_groups"][0]["lr"]
    want_lr = _lrs(method, steps + 1)[-1]
    print(f"train entry point {method}: the lr after {steps} steps {lr!r}"
          + (f", every milestone {MILESTONES} crossed"
             if get_algorithm_spec(method).per_batch_multistep else ""))
    if lr != want_lr:
        raise AssertionError(f"the lr after the epoch is {lr!r}, not "
                             f"{want_lr!r}")
    on_card, on_cpu = (serving_model(method, dataset, dataset_id,
                                     ckpt["model_dict"],
                                     batch_size=SERVE_BATCH, device=dev)
                       for dev in ("cuda", "cpu"))
    sel = _replayer(method)
    with _during(sel, "record"):
        got = on_card(test_x)
    with _during(sel, "replay"):
        want_pred = on_cpu(test_x)
    what = f"{dataset} test windows{f' of {key}' if key else ''}"
    if sel:
        sel.report(method, f"{what}, trained weights")
    if got.shape != (len(test_x),) or not np.isfinite(got).all():
        raise AssertionError(f"checkpoint serves {got.shape} or non-finite")
    np.testing.assert_allclose(got, want_pred, atol=SERVE_ATOL,
                               rtol=SERVE_RTOL)
    print(f"train entry point {method}: checkpoint.pt serves {len(test_x)} "
          f"{what} on the card as on the CPU (atol={SERVE_ATOL}, "
          f"rtol={SERVE_RTOL})")

    _reset()
    evaluated = cli.main(args + ["--eval_torch_checkpoint", ckpt_path])
    torch.cuda.synchronize()
    eval_launches = _counts(path.kernel)[0]
    _only_its_kernel(method, "evaluate_only")
    eval_diff = max(float(np.max(np.abs(np.subtract(evaluated[k], best[k]))
                                 / np.maximum(np.abs(best[k]), 1e-30)))
                    for k in best)
    print(f"train entry point {method}: cli.main --eval_torch_checkpoint "
          f"on checkpoint.pt: (Score_v1, Score_v2, MAE, RMSE) of "
          f"{len(evaluated)} test set(s) equal the trainer's, largest "
          f"relative difference {eval_diff:.3e}; launches forward "
          f"{eval_launches}")
    for k in best:
        np.testing.assert_allclose(evaluated[k], best[k], rtol=1e-5)
    if eval_launches != path.per_forward * evals:
        raise AssertionError(f"evaluate_only launched {eval_launches}, not "
                             f"{path.per_forward * evals}")
    art_path = os.path.join(run_dir, "model.pt2")
    line = export.main(["--checkpoint", ckpt_path, "--GNN_method", method,
                        "--dataset", dataset, "--dataset_id", dataset_id,
                        "--out", art_path, "--batch_size", str(SERVE_BATCH),
                        "--max_rul", str(data.max_rul)])
    got_art = export.load_artifact(art_path)(test_x)
    np.testing.assert_allclose(got_art, got, atol=ARTIFACT_ATOL,
                               rtol=ARTIFACT_RTOL)
    print(f"train entry point {method}: python -m gnn_rul_tpu_torch.export "
          f"wrote {line['bytes']} bytes; the artifact serves the test "
          f"windows as the live model on the card does (atol="
          f"{ARTIFACT_ATOL}, rtol={ARTIFACT_RTOL})")
    return fwd_launches, bwd_launches, bwd_calls, eval_launches


def _write_raw_fd001(root: str, seed: int = 5):
    """A raw C-MAPSS FD001 tree at its real size, in the files' format:
    100 train engines of 20,631 rows and 100 test engines of 13,096 (some
    shorter than the window), 26 space-separated columns ending in two
    blanks; the RUL file one value and a blank a line. Returns the train
    lengths and the test RULs."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "CMAPSSData")
    os.makedirs(base)
    fmt = ["%d", "%d", "%.4f", "%.4f", "%.1f"] + ["%.4f"] * 21
    train_len = _engine_lengths(rng, FD001_ROWS, 128, 363)
    test_len = _engine_lengths(rng, FD001_TEST_ROWS, 31, 303)
    for name, lengths in (("train", train_len), ("test", test_len)):
        tables = []
        for eid, n in enumerate(lengths, start=1):
            cycle = np.arange(1, n + 1)
            wear = (cycle / n)[:, None] * rng.uniform(-1, 1, 21)
            wear[:, list(_FD001_FLAT)] = 0.0
            noise = rng.normal(scale=0.002, size=(n, 21))
            noise[:, list(_FD001_FLAT)] = 0.0
            sensors = np.asarray(_FD001_LEVELS) * (1 + 0.01 * wear + noise)
            tables.append(np.column_stack([
                np.full(n, eid), cycle,
                rng.normal(scale=0.002, size=n).round(4),
                rng.normal(scale=0.0003, size=n).round(4),
                np.full(n, 100.0), sensors]))
        np.savetxt(os.path.join(base, f"{name}_FD001.txt"),
                   np.concatenate(tables), fmt=fmt, delimiter=" ",
                   newline="  \n")
    ruls = rng.integers(7, 146, FD001_ENGINES)
    with open(os.path.join(base, "RUL_FD001.txt"), "w") as f:
        f.writelines(f"{r} \n" for r in ruls)
    return train_len, ruls


def _write_raw_phm2012(root: str, files: int = 50, seed: int = 6) -> None:
    """A raw PHM2012 Condition_1 tree in FEMTO's format: ``files`` acc files
    for each of its seven bearings, 2,560 rows of (hour, minute, second,
    microsecond, horizontal and vertical acceleration) each; Bearing1_3's
    files are ';'-separated, as some of FEMTO's are."""
    rng = np.random.default_rng(seed)
    base = os.path.join(root, "PHM_2012_Bearing_Datasets")
    split = phm2012.TRAIN_TEST_SPLIT
    micro = 39 * np.arange(SIGNAL_LENGTH)
    for folder, names in (("Learning_set", split["Condition1_train"]),
                          ("Test_set", split["Condition1_test"])):
        for name in names:
            d = os.path.join(base, folder, name)
            os.makedirs(d)
            for i in range(files):
                acc = rng.normal(scale=0.2 + i / files,
                                 size=(SIGNAL_LENGTH, 2))
                table = np.column_stack([
                    np.full(SIGNAL_LENGTH, 9), np.full(SIGNAL_LENGTH, i // 6),
                    np.full(SIGNAL_LENGTH, 10 * (i % 6)), 65664 + micro, acc])
                np.savetxt(os.path.join(d, f"acc_{i + 1:05d}.csv"), table,
                           fmt=["%d"] * 4 + ["%.3f"] * 2,
                           delimiter=";" if name == "Bearing1_3" else ",")


def _preprocess_cli(*argv: str) -> None:
    """``python -m gnn_rul_tpu_torch.data.preprocess *argv``, run in this
    process, so that what it imports stays visible."""
    kept = sys.argv
    sys.argv = ["gnn_rul_tpu_torch.data.preprocess", *argv]
    try:
        runpy.run_module("gnn_rul_tpu_torch.data.preprocess",
                         run_name="__main__")
    finally:
        sys.argv = kept


def _train_from(method: str, dataset: str, dataset_id: str, root: str,
                save_dir: str) -> None:
    """``cli.main`` trains one epoch of ``method`` from the processed set
    under ``root``; the kernels' launches must be the method's path's
    exactly."""
    data = load_processed(os.path.join(root, dataset, dataset_id), "train")
    test = load_processed(os.path.join(root, dataset, dataset_id), "test")
    tests = (test["samples"].values() if isinstance(test["samples"], dict)
             else [test["samples"]])
    path = _path(method)
    _reset()
    t0 = time.perf_counter()
    results = cli.main(["--GNN_method", method, "--dataset", dataset,
                        "--dataset_id", dataset_id, "--data_path", root,
                        "--save_dir", save_dir, "--epochs", "1",
                        "--num_runs", "1"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _counts(path.kernel)
    _only_its_kernel(method, "preprocess")
    steps = -(-len(data["samples"]) // SERVE_BATCH)
    evals = sum(-(-len(x) // SERVE_BATCH) for x in tests)
    want = (path.train_per_forward * steps + path.per_forward * evals,
            path.train_per_forward * path.bwd_per_call * steps)
    best = results[0]
    print(f"preprocess: {method} trained 1 epoch from the preprocessed "
          f"{dataset}/{dataset_id} ({len(data['samples'])} windows) in "
          f"{wall:.2f} s; best {best}; launches (forward, backward) "
          f"{launches}")
    if launches != want:
        raise AssertionError(f"expected (forward, backward) launches {want}, "
                             f"got {launches}")
    if not all(np.isfinite(v).all() for v in best.values()):
        raise AssertionError(f"metrics {best}")


def _preprocess(tmp: str) -> None:
    """The offline path from raw files, pandas never imported: a raw FD001
    tree at its real size through ``python -m
    gnn_rul_tpu_torch.data.preprocess --dataset CMAPSS`` (15,731 train
    windows and 100 test windows, each label the capped RUL at its
    window's end), FC_STGNN trained one epoch from its output through
    ``cli.main``; a raw PHM2012 Condition_1 tree of 2,560 x 6 files, 50 a
    bearing (one bearing ';'-separated), preprocessed, and SAGCN trained
    one epoch from it."""
    raw, out = os.path.join(tmp, "raw"), os.path.join(tmp, "preprocessed")
    save_dir = os.path.join(tmp, "preprocess_logs")
    t0 = time.perf_counter()
    train_len, ruls = _write_raw_fd001(raw)
    t1 = time.perf_counter()
    _preprocess_cli("--dataset", "CMAPSS", "--data_root", raw,
                    "--dataset_id", "FD001", "--out_dir", out)
    t2 = time.perf_counter()
    fd001 = os.path.join(out, "CMAPSS", "FD001")
    train, test = (load_processed(fd001, split) for split in ("train",
                                                              "test"))
    labels = np.concatenate([
        np.minimum(n - np.arange(WINDOW, n + 1), MAX_RUL) / MAX_RUL
        for n in train_len]).astype(np.float32)[:, None]
    test_labels = (np.minimum(ruls, MAX_RUL) / MAX_RUL).astype(
        np.float32)[:, None]
    print(f"preprocess: raw FD001 ({FD001_ROWS} train rows, "
          f"{FD001_TEST_ROWS} test rows) written in {t1 - t0:.2f} s, "
          f"preprocessed in {t2 - t1:.2f} s: train {train['samples'].shape}, "
          f"test {test['samples'].shape}, train windows in "
          f"[{train['samples'].min():.4f}, {train['samples'].max():.4f}]")
    if train["samples"].shape != (FD001_ROWS - FD001_ENGINES * (WINDOW - 1),
                                  WINDOW, 14) \
            or test["samples"].shape != (FD001_ENGINES, WINDOW, 14):
        raise AssertionError("FD001 preprocessed to other shapes")
    if not (np.array_equal(train["labels"], labels)
            and np.array_equal(test["labels"], test_labels)):
        raise AssertionError("a label is not the capped RUL at its "
                             "window's end")
    if not (0.0 <= train["samples"].min() and train["samples"].max() <= 1.0):
        raise AssertionError("FD001's one condition does not scale to "
                             "[0, 1]")
    _train_from("FC_STGNN", "CMAPSS", "FD001", out, save_dir)

    t0 = time.perf_counter()
    _write_raw_phm2012(raw)
    t1 = time.perf_counter()
    _preprocess_cli("--dataset", "PHM2012", "--data_root", raw,
                    "--condition", "1", "--out_dir", out)
    t2 = time.perf_counter()
    c1 = os.path.join(out, "PHM2012", "Condition_1")
    train, test = (load_processed(c1, split) for split in ("train", "test"))
    print(f"preprocess: raw PHM2012 Condition_1 (7 bearings x 50 files of "
          f"{SIGNAL_LENGTH} x 6) written in {t1 - t0:.2f} s, preprocessed "
          f"in {t2 - t1:.2f} s: train {train['samples'].shape}, test "
          f"{ {b: v.shape for b, v in test['samples'].items()} }, max_ruls "
          f"{train['max_ruls']}")
    if train["samples"].shape != (100, SIGNAL_LENGTH) \
            or sorted(test["samples"]) != phm2012.TRAIN_TEST_SPLIT[
                "Condition1_test"] \
            or train["max_ruls"]["Bearing1_4"] != 50 + 33.9:
        raise AssertionError("PHM2012 preprocessed to other shapes")
    _train_from("SAGCN", "PHM2012", "Condition_1", out, save_dir)
    if "pandas" in sys.modules:
        raise AssertionError("pandas was imported")
    print("preprocess: raw files to training on the card, pandas never "
          "imported")


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


def _request_ms(model, x, warmup: int = 5, reps: int = 20) -> float:
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
             reps: int = 5) -> None:
    """Print the card's time per ``fn()`` by kernel and copy
    (torch.profiler), its share of the traced calls' own wall time (the
    same window), and beside it its share of ``untraced_ms``, the time of
    one call measured in a separate run without the profiler (which slows
    the host down; the card's time in one window over the wall time of
    another can pass 100%)."""
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
          f"{100 * busy_us / traced_us:.1f}% of the traced {unit} "
          f"({traced_us:.1f} us), {100 * busy_us / (untraced_ms * 1e3):.1f}% "
          f"of the untraced {unit} (a separate run); the port's kernels "
          f"{ours_us:.1f} us ({100 * ours_us / busy_us:.1f}% of busy); "
          f"by kernel:")
    for e in on_card[:16]:
        print(f"  {e.device_time_total / reps:9.1f} us  "
              f"x{e.count / reps:g}  {e.key[:72]}")
    return busy_us, traced_us


def _peak(elt: int) -> float:
    """The card's peak operations a second for operands of ``elt`` bytes:
    fp32 outside the tensor cores, or bf16 dense."""
    return FP32_FLOP_PER_S if elt == 4 else BF16_FLOP_PER_S


def _bound_ms(b: int, n: int, d: int, f: int, backward: bool = False,
              groups: int = 1, elt: int = 4):
    """Least time for the chain on an H100 SXM, the larger of its bytes at
    the HBM rate and its fp32 operations at the fp32 peak. Forward: h, x,
    the ``groups`` masks read and out written; 2*B*N^2*(D+F) operations.
    Backward without dmask: h, x, g, the masks read and dh, dx written;
    2*B*N^2*(3D+2F) operations (S, dA, dx, dS h, dS^T h). ``elt`` 2: bf16
    operands, the operations at the bf16 peak."""
    if backward:
        nbytes = elt * (2 * b * n * d + 3 * b * n * f + groups * n * n)
        flops = 2 * b * n * n * (3 * d + 2 * f)
    else:
        nbytes = elt * (b * n * d + 2 * b * n * f + groups * n * n)
        flops = 2 * b * n * n * (d + f)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / _peak(elt) * 1e3
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


def _gat_bound_ms(b: int, n: int, d: int, adj: str, groups: int = 1,
                  elt: int = 4):
    """Least time for the graph attention on an H100 SXM, the larger of its
    bytes at the HBM rate and its fp32 operations at the fp32 peak: wh, f1,
    f2, adj (one (N, N) when shared, one a group when "grouped") and the
    ``groups`` biases read and out written; 2*B*N^2*D for the product with
    wh and 6*B*N^2 for the logits, the leaky_relu, the exponent, the
    normalisation and the mask."""
    adjs = {"shared": 1, "path": 1, "grouped": groups}.get(adj, b)
    nbytes = elt * (2 * b * n * d + 2 * b * n + adjs * n * n + groups)
    flops = 2 * b * n * n * d + 6 * b * n * n
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / _peak(elt) * 1e3
    return max(by_bytes, by_ops), ("bytes" if by_bytes >= by_ops
                                   else "operations")


def _gat_times(cases):
    """{case: (kernel ms, plain ms, bound ms, bound by)} at ``cases`` of
    GAT_CASES. No single PyTorch call computes a softmax followed by a
    multiplicative mask and the product, so there is no library time."""
    times = {}
    for case in cases:
        b, n, d, adj, bias, slope = case
        args = _gat_inputs(b, n, d, adj, bias, seed=0)
        times[case] = (
            _graph_ms(lambda: fused_gat.fused_gat.forward(*args, slope)),
            _graph_ms(lambda: fused_gat.fused_gat_plain(*args, slope)),
            *_gat_bound_ms(b, n, d, adj))
        print(f"times [{SMI}]: fused_gat B={b} N={n} D={d} adj={adj}: "
              + "kernel {:.6f} "
              "ms, plain {:.6f} ms, bound {:.6f} ms ({}); library none"
              .format(*times[case]))
    return times


def _step_ms(engine: Engine, x, y, warmup: int = 5, reps: int = 20) -> float:
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


def _lstm_bound_ms(t: int, b: int, h: int, backward: bool = False,
                   groups: int = 1, elt: int = 4):
    """Least time for the recurrence on an H100 SXM, the larger of its bytes
    at the HBM rate and its fp32 operations at the fp32 peak, per (step,
    direction, column). Forward: xg and w_hh read, ys and the c trajectory
    written; 8H^2 for the recurrent product, 4H gate additions, 5H
    activations and 5H for the cell. Backward: xg, w_hh, ys, cs, dys and
    dc_fin read, dxg and dw_hh written; three recurrent products (the
    recomputed gates, dh, dW: 24H^2) and 4H + 5H + 5H + 16H elementwise.
    ``groups`` W_hh and dW_hh where the columns are in groups."""
    rows = t * 2 * b
    if backward:
        nbytes = elt * (rows * (4 * h + 3 * h + 4 * h)
                        + 2 * groups * 2 * h * 4 * h + 2 * b * h)
        flops = rows * (24 * h * h + 30 * h)
    else:
        nbytes = elt * (rows * (4 * h + 2 * h) + groups * 2 * h * 4 * h)
        flops = rows * (8 * h * h + 14 * h)
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = flops / _peak(elt) * 1e3
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

        # cuDNN's calls a timed run: 10 up to T = 200, fewer above (one
        # from T = 1,400; HAGCN's T = 14,000 takes ~60 ms forward, ~120 ms
        # forward and backward), a depth cut in PR 11 (PERF.md §4).
        lib_inner = max(1, min(10, 2000 // t))
        train_fwd = _event_ms(lambda: lib(x), inner=lib_inner)
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
                    *_lstm_bound_ms(t, b, h),
                    _event_ms(lib_fwd, inner=lib_inner)),
            "bwd": (_graph_ms(lambda: kernel.backward(xg, w, ys, cs, dys,
                                                      dcf), inner=calls),
                    _graph_ms(lambda: fused_lstm.lstm_recurrence_bwd_plain(
                        xg, w, ys, cs, dys, dcf), inner=max(1, inner // 3),
                        reps=plain_reps),
                    *_lstm_bound_ms(t, b, h, backward=True),
                    _event_ms(lib_train, inner=lib_inner) - train_fwd),
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


# Kernel #4's step phases as its stamps count them, by step design: the
# library built with -DLSTM_STAMPS (csrc/fused_lstm.cu), thread 0 of the
# first CTA, clocks from the end of one phase to the end of the next.
STAMP_PHASES = {
    "classic": ("copies issued", "product", "reduce", "inputs + barrier 1",
                "activation", "barrier 2", "cell", "ys/cs stores",
                "h stores", "end barrier"),
    "ring": ("inputs", "product", "reduce", "activation", "gather", "cell",
             "h stored and sent", "ys/cs stores", "ring released",
             "wait for h + barrier"),
}
STAMP_SHAPES = ((1400, 5, 60), (1400, 5, 120))


def _stamp_library():
    """The stamped build of csrc/fused_lstm.cu, loaded with ctypes."""
    lib = ctypes.CDLL(str(build.build_variant("fused_lstm", "LSTM_STAMPS")))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.fused_lstm_fwd_stamped.argtypes = [ptr] * 5 + [i32] * 5 + [ptr] * 2
    lib.fused_lstm_fwd_stamped.restype = i32
    lib.fused_lstm_stamp_phases.restype = i32
    return lib


def _lstm_stamps(shapes=STAMP_SHAPES, step: int = -1, cluster: int = 0,
                 runs: int = 3) -> dict:
    """Clocks a step of kernel #4's forward by phase (the median of
    ``runs`` launches) at each (T, B, H) of ``shapes``, on the plan's step
    or ``step`` (an index of ``fused_lstm.STEPS``) and cluster or
    ``cluster`` CTAs; prints them beside the kernel's time a step from
    events on the stamped library. Returns {shape: {phase: clocks}}."""
    lib = _stamp_library()
    n = lib.fused_lstm_stamp_phases()
    out = {}
    for t, b, h in shapes:
        xg, w, _, _ = _lstm_inputs(t, b, h, seed=0)
        ys = torch.empty((t, 2, b, h), device="cuda")
        cs, cf = torch.empty_like(ys), torch.empty((2, b, h), device="cuda")
        plan = fused_lstm.lstm_recurrence.plan(h, b)
        name = fused_lstm.STEPS[step] if step >= 0 else plan.get(
            "step", "classic")
        rows, times = [], []
        for _ in range(runs):
            buf = torch.zeros(n + 2, dtype=torch.int64, device="cuda")
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            err = lib.fused_lstm_fwd_stamped(
                xg.data_ptr(), w.data_ptr(), ys.data_ptr(), cs.data_ptr(),
                cf.data_ptr(), t, b, h, step, cluster, buf.data_ptr(),
                torch.cuda.current_stream().cuda_stream)
            end.record()
            if err != 0:
                raise RuntimeError(f"stamped forward T={t} B={b} H={h} step "
                                   f"{step} cluster {cluster}: error {err}")
            end.synchronize()
            rows.append(buf.tolist())
            times.append(start.elapsed_time(end))
        vals = [statistics.median(col) for col in zip(*rows)]
        steps = vals[n + 1]
        phases = dict(zip(STAMP_PHASES[name], (v / steps for v in vals[:n])))
        c = cluster or plan["cluster"]
        per_step = vals[n] / steps
        print(f"stamps [{SMI}] T={t} B={b} H={h} step {name}, cluster of "
              f"{c}: {per_step:.1f} clocks a step, "
              f"{statistics.median(times) / t * 1e3:.3f} us a step (events, "
              f"stamped build); " + ", ".join(
                  f"{k} {v:.1f}" for k, v in phases.items()), flush=True)
        out[(t, b, h)] = phases
    return out


# Kernel #4's forward alone, CUDA graphs, at every shape of PERF.md §6 row
# 4, (T, B, H, G); a turn uses only what earlier trees' chip_smoke.py has,
# so ``_turns(parent, _LSTM_FWD_TURN)`` times an unpacked parent beside this
# tree.
LSTM_FWD_SHAPES = ((100, 70, 24, 1), (100, 70, 48, 1), (1000, 70, 48, 1),
                   (1400, 5, 60, 1), (1400, 5, 120, 1), (14000, 5, 120, 1),
                   (100, 544, 30, 1), (100, 200, 30, 1), (100, 200, 60, 1),
                   (1139, 200, 60, 1), (100, 350, 48, 5), (100, 1000, 30, 5),
                   (1400, 25, 120, 5))
_LSTM_FWD_TURN = f"""
import torch
import chip_smoke as c
c._device(); c.build.build_libraries()
k = c.fused_lstm.lstm_recurrence
k.load()
for t, b, h, g in {LSTM_FWD_SHAPES!r}:
    xg, w, _, _ = c._lstm_inputs(t, b, h, seed=0)
    if g > 1:
        w = torch.stack([w] * g).contiguous()
    ms = c._graph_ms(lambda: k.forward(xg, w), inner=max(1, min(50, 20000 // t)))
    print(f"fwd turn [{{c.SMI}}] T={{t}} B={{b}} H={{h}} G={{g}}: {{ms:.6f}} ms "
          f"({{ms / t * 1e3:.4f}} us a step) plan {{k.plan(h, b)}}", flush=True)
"""


def _serve_times(method: str, fixed, symbolic, x100, x1000) -> None:
    # The forward alone: 10 forwards a CUDA graph at batch 100, 2 at 1000
    # (a depth cut in PR 11, PERF.md §4: HAGCN's forward of 1000 takes
    # ~42 ms).
    for name, model, xs, inner in (("batch 100", fixed, x100, 10),
                                   ("batch 1000", symbolic, x1000, 2)):
        req_ms = _request_ms(model, xs)
        x_dev = torch.from_numpy(xs).cuda()
        with torch.inference_mode():
            fwd_ms = _graph_ms(lambda: model.model(x_dev), inner=inner)
        print(f"serve {method} {name} [{SMI}]: {req_ms:.4f} ms/request, "
              f"{len(xs) / req_ms * 1e3:.1f} samples/s; the forward's device "
              f"work alone (CUDA graph) {fwd_ms:.4f} ms")
        _profile(f"serve {method} {name}", lambda: model(xs), req_ms,
                 "request")


def _artifact_times(method: str, artifact, symbolic, x100) -> None:
    """A request of 100 through the symbolic-batch artifact and the live
    symbolic-batch model, in turns: live, artifact, artifact, live (the
    request of 1000 is cut since PR 14, a timing depth, PERF.md §4)."""
    for xs in (x100,):
        live_a, art_a, art_b, live_b = (
            _request_ms(model, xs)
            for model in (symbolic, artifact, artifact, symbolic))
        print(f"serve {method} request of {len(xs)} [{SMI}]: artifact "
              f"{art_a:.4f} / {art_b:.4f} ms/request, live model "
              f"{live_a:.4f} / {live_b:.4f} (in turns: live, artifact, "
              f"artifact, live)")
        _profile(f"serve artifact {method} request of {len(xs)}",
                 lambda: artifact(xs), art_a, "request")


def _train_times(method: str, data: _Processed) -> None:
    train_x, train_y = data.train_x, data.train_y
    dataset, dataset_id = CELL[method]
    torch.manual_seed(0)
    engine = Engine(build_model(method, dataset, dataset_id),
                    get_algorithm_spec(method),
                    train_params(dataset, dataset_id, method))
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
    engine.run_epoch(train_x, train_y, 1,
                     shuffle=get_dataset_config(dataset).shuffle)
    epoch_s = time.perf_counter() - t0
    steps = -(-len(train_x) // SERVE_BATCH)
    path = _path(method)
    print(f"train {method} [{SMI}]: {step_ms:.4f} ms per step at batch "
          f"{SERVE_BATCH} (median of 20); one epoch of {len(train_x)} "
          f"windows in {steps} steps {epoch_s:.4f} s, "
          f"{len(train_x) / epoch_s:.1f} samples/s; launches per step "
          f"forward {path.train_per_forward}, backward "
          f"{path.train_per_forward * path.bwd_per_call}")
    _profile(f"train step {method}", lambda: engine.train_step(xb, yb),
             step_ms, "step")


# Seed-parallel runs (train/vectorized.py), phase 10: the reference's five
# runs, seed = run index, at once; the methods on each kernel, HAGCN (the
# recurrence at B = 5 x its patches), LOGO_bearing (its trunk at B = 5 x
# 200) and one method on no kernel (GRU_CM: cuDNN's GRU, a call a seed).
SEEDS = 5
VECTORIZED_METHODS = ("FC_STGNN", "LOGO", "STAGNN", "STFA", "HAGCN",
                      "LOGO_bearing", "GRU_CM")


def _library_rnn_layers(model) -> int:
    """The layers of ``model`` that run cuDNN's LSTM or GRU, which under
    vmap call ``library_rnn`` once a seed."""
    return sum(isinstance(m, (recurrent.LSTMLayer, recurrent.GRULayer))
               or (isinstance(m, (recurrent.LSTM, recurrent.GRU))
                   and not m.bidirectional)
               for m in model.modules())


def _seed_slices(t: torch.Tensor, groups: int, axis: int = 0):
    """Each group's contiguous slice of ``t`` along ``axis``."""
    return [c.contiguous() for c in t.chunk(groups, dim=axis)]


def _bitwise(what: str, got, want) -> bool:
    same = all(torch.equal(g, w) for g, w in zip(got, want))
    print(f"{what}: each group's slice {'equals' if same else 'DIFFERS from'}"
          f" the ungrouped call's, bit for bit")
    return same


def _grouped_gnn_vs_plain(b: int, n: int, d: int, f: int, groups: int,
                          seed: int):
    """The dot-graph kernels with a (G, N, N) mask: out, dh, dx and each
    group's dmask against the grouped plain versions by :func:`_hold`; one
    launch each way; each group's out, dh, dx and per-sample dmask equal
    the ungrouped kernels' on its graphs, bit for bit (a graph's arithmetic
    is the same at every grouping on the whole-graph plans)."""
    kernel = fused_gnn.fused_dot_graph_spmm
    h, x, _ = _fused_inputs(b, n, d, f, seed)
    rng = np.random.default_rng(seed)
    mask = torch.as_tensor(rng.uniform(size=(groups, n, n)),
                           dtype=torch.float32).cuda()
    g = torch.randn(x.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(seed))
    before = kernel.launches, kernel.bwd_launches
    out = kernel.forward(h, x, mask)
    dh, dx, dm = kernel.backward(h, x, mask, g, need_dmask=True)
    launches = (kernel.launches - before[0], kernel.bwd_launches - before[1])
    per = b // groups
    what = f"grouped dot graph B={b} N={n} D={d} F={f} G={groups}"
    if launches != (1, fused_gnn.bwd_launches_per_call(n, d, f)):
        raise AssertionError(f"{what}: launched {launches}")
    p_out = fused_gnn.fused_dot_graph_spmm_plain(h, x, mask)
    pdh, pdx, pdm = fused_gnn.fused_dot_graph_spmm_bwd_plain(h, x, mask, g)
    torch.cuda.synchronize()
    exact = functools.cache(lambda: (
        fused_gnn.fused_dot_graph_spmm_plain(h.double(), x.double(),
                                             mask.double()),
        *fused_gnn.fused_dot_graph_spmm_bwd_plain(
            h.double(), x.double(), mask.double(), g.double())))

    def by_group(t):
        return t.unflatten(0, (groups, per)).sum(dim=1)

    worst = max(_hold(f"{what} out", out, p_out, lambda: exact()[0]),
                *(_hold(f"{what} {name}", got, want, lambda k=k: exact()[k])
                  for k, (name, got, want) in enumerate(
                      (("dh", dh, pdh), ("dx", dx, pdx)), start=1)),
                _hold(f"{what} dmask", by_group(dm), by_group(pdm),
                      lambda: by_group(exact()[3])))
    own = [(kernel.forward(hs, xs, ms),
            *kernel.backward(hs, xs, ms, gs, need_dmask=True))
           for hs, xs, ms, gs in zip(_seed_slices(h, groups),
                                     _seed_slices(x, groups),
                                     _seed_slices(mask, groups),
                                     _seed_slices(g, groups))]
    same = _bitwise(what, [torch.cat(parts) for parts in zip(*own)],
                    (out, dh, dx, dm))
    if fused_gnn.fwd_plan(b, n, d, f)["whole"] \
            and fused_gnn.fwd_plan(per, n, d, f)["whole"] and not same:
        raise AssertionError(f"{what}: a group differs from its ungrouped "
                             f"call on the same per-graph arithmetic")
    return worst


def _grouped_lstm_vs_plain(t: int, b: int, h: int, groups: int, seed: int):
    """The recurrence kernels with w_hh (G, 2, H, 4H): ys, cs, c_fin, dxg and
    each group's dW_hh against the grouped plain versions by :func:`_hold`;
    one forward launch and four backward; each group's outputs equal the
    ungrouped kernels' on its columns, bit for bit, where both take the
    same plan (the plan reads the whole B: at HAGCN's B = 25 a cluster of
    2, at its B = 5 of 8)."""
    kernel = fused_lstm.lstm_recurrence
    xg, _, dys, dcf = _lstm_inputs(t, b, h, seed)
    rng = np.random.default_rng(seed + 1)
    w = torch.as_tensor(rng.uniform(-1, 1, size=(groups, 2, h, 4 * h))
                        / np.sqrt(h), dtype=torch.float32).cuda()
    before = kernel.launches, kernel.bwd_launches
    ys, cs, c_fin = kernel.forward(xg, w)
    dxg, dw = kernel.backward(xg, w, ys, cs, dys, dcf)
    launches = (kernel.launches - before[0], kernel.bwd_launches - before[1])
    per = b // groups
    plans = [(kernel.plan(h, cols), kernel.plan(h, cols, backward=True))
             for cols in (b, per)]
    what = (f"grouped lstm T={t} B={b} H={h} G={groups} (cluster of "
            f"{plans[0][0]['cluster']}; ungrouped B={per}: cluster of "
            f"{plans[1][0]['cluster']})")
    if launches != (1, fused_lstm.BWD_LAUNCHES_PER_CALL):
        raise AssertionError(f"{what}: launched {launches}")
    p_ys, p_cs = fused_lstm.lstm_trajectory_plain(xg, w)
    p_dxg, p_dw = fused_lstm.lstm_recurrence_bwd_plain(xg, w, ys, cs, dys,
                                                       dcf)
    torch.cuda.synchronize()
    fwd64 = functools.cache(lambda: fused_lstm.lstm_trajectory_plain(
        xg.double(), w.double()))
    bwd64 = functools.cache(lambda: fused_lstm.lstm_recurrence_bwd_plain(
        *(a.double() for a in (xg, w, ys, cs, dys, dcf))))
    worst_fwd = max(
        _hold(f"{what} ys", ys, p_ys, lambda: fwd64()[0]),
        _hold(f"{what} cs", cs, p_cs, lambda: fwd64()[1]),
        _hold(f"{what} c_fin", c_fin, p_cs[-1], lambda: fwd64()[1][-1]))
    worst_bwd = max(_hold(f"{what} dxg", dxg, p_dxg, lambda: bwd64()[0]),
                    _hold(f"{what} dw", dw, p_dw, lambda: bwd64()[1]))
    own = []
    for xs, ws, ds, cf in zip(_seed_slices(xg, groups, 2),
                              _seed_slices(w, groups),
                              _seed_slices(dys, groups, 2),
                              _seed_slices(dcf, groups, 1)):
        ws = ws[0]
        y1, c1, f1 = kernel.forward(xs, ws)
        own.append((y1, c1, f1, *kernel.backward(xs, ws, y1, c1, ds, cf)))
    cat = [torch.cat(parts, dim=axis) for parts, axis in
           zip(zip(*own), (2, 2, 1, 2))] + [torch.stack([o[4] for o in own])]
    same = _bitwise(what, cat, (ys, cs, c_fin, dxg, dw))
    if plans[0] == plans[1] and not same:
        raise AssertionError(f"{what}: a group differs from its ungrouped "
                             f"call on the same plan")
    return worst_fwd, worst_bwd


def _grouped_gat_vs_plain(b: int, n: int, d: int, adj: str, groups: int,
                          seed: int):
    """The attention kernel with one bias a group and the adjacency
    ``adj``: "per-graph" (B, N, N), "grouped" (G, N, N) or "path" (one
    (N, N)): against the grouped plain version by :func:`_hold`, one launch;
    each group's answer equals the ungrouped kernel's on its graphs, bit
    for bit (a graph's arithmetic is the same at every plan)."""
    kernel = fused_gat.fused_gat
    wh, f1, f2, a, _ = _gat_inputs(b, n, d, "path" if adj == "path"
                                   else "per-graph", 0.3, seed)
    rng = np.random.default_rng(seed)
    if adj == "grouped":
        a = a[::b // groups].contiguous()  # each group's first graph's
    bias = torch.as_tensor(rng.normal(size=groups) * 0.3,
                           dtype=torch.float32).cuda()
    before = kernel.launches
    out = kernel.forward(wh, f1, f2, a, bias, 0.1)
    if kernel.launches - before != 1:
        raise AssertionError("the grouped attention launched "
                             f"{kernel.launches - before}")
    want = fused_gat.fused_gat_plain(wh, f1, f2, a, bias, 0.1)
    torch.cuda.synchronize()
    what = f"grouped gat B={b} N={n} D={d} adj={adj} G={groups}"
    worst = _hold(what, out, want, lambda: fused_gat.fused_gat_plain(
        *(t.double() for t in (wh, f1, f2, a, bias)), 0.1))
    adjs = {"per-graph": _seed_slices(a, groups),
            "grouped": [a[k].contiguous() for k in range(groups)],
            "path": [a] * groups}[adj]
    own = [kernel.forward(*parts, adj_g, bias[k:k + 1].contiguous(), 0.1)
           for k, (adj_g, *parts) in enumerate(zip(
               adjs, *(_seed_slices(t, groups) for t in (wh, f1, f2))))]
    if not _bitwise(what, [torch.cat(own)], [out]):
        raise AssertionError(f"{what}: a group differs from its ungrouped "
                             f"call")
    return worst


# The grouped shapes of the five seeds at each method's batch of 100.
GROUPED_GNN = ((SEEDS * SERVE_BATCH, *FC_STGNN_NDF),)
GROUPED_LSTM = ((100, SEEDS * 70, 48),      # LOGO
                (1400, SEEDS * 5, 60),      # HAGCN
                (1400, SEEDS * 5, 120),     # HAGCN, widest layer
                (1400, 5, 120),             # a column a group: cluster of 8
                (100, SEEDS * 200, 30))     # LOGO_bearing
GROUPED_GAT = ((SEEDS * SERVE_BATCH, 14, 64, "per-graph"),      # STAGNN
               (SEEDS * SERVE_BATCH * 25, 14, 5, "grouped"),    # STFA
               (SEEDS * SERVE_BATCH, 40, 300, "path"))          # GAT_LSTM


def _grouped_vs_plain():
    """Every kernel with the seed axis folded in, at the vectorized
    phase's shapes. Returns the largest errors (dot graph, LSTM forward,
    LSTM backward, attention)."""
    gnn = max(_grouped_gnn_vs_plain(*shape, SEEDS, seed=600 + i)
              for i, shape in enumerate(GROUPED_GNN))
    lstm = [_grouped_lstm_vs_plain(t, b, h, SEEDS, seed=610 + i)
            for i, (t, b, h) in enumerate(GROUPED_LSTM)]
    gat = max(_grouped_gat_vs_plain(*case, SEEDS, seed=620 + i)
              for i, case in enumerate(GROUPED_GAT))
    return gnn, max(e[0] for e in lstm), max(e[1] for e in lstm), gat


def _grouped_times():
    """{name: (kernel ms, plain ms, bound ms, bound by)} of the grouped
    kernels at the five seeds' shapes, CUDA graphs as :func:`_graph_ms`."""
    times = {}
    b, n, d, f = GROUPED_GNN[0]
    h, x, _ = _fused_inputs(b, n, d, f, 0)
    mask = torch.rand((SEEDS, n, n), device="cuda")
    g = torch.randn(x.shape, device="cuda")
    kernel = fused_gnn.fused_dot_graph_spmm
    times["dot graph"] = (
        _graph_ms(lambda: kernel.forward(h, x, mask)),
        _graph_ms(lambda: fused_gnn.fused_dot_graph_spmm_plain(h, x, mask)),
        *_bound_ms(b, n, d, f, groups=SEEDS))
    times["dot graph bwd"] = (
        _graph_ms(lambda: kernel.backward(h, x, mask, g)),
        _graph_ms(lambda: fused_gnn.fused_dot_graph_spmm_bwd_plain(
            h, x, mask, g)),
        *_bound_ms(b, n, d, f, backward=True, groups=SEEDS))
    lstm = fused_lstm.lstm_recurrence
    for t, b, h in (GROUPED_LSTM[0], GROUPED_LSTM[-1]):
        xg, _, dys, dcf = _lstm_inputs(t, b, h, 0)
        w = torch.rand((SEEDS, 2, h, 4 * h), device="cuda") / h
        ys, cs, _ = lstm.forward(xg, w)
        times[f"lstm {t}x{b}x{h}"] = (
            _graph_ms(lambda: lstm.forward(xg, w)),
            _graph_ms(lambda: fused_lstm.lstm_trajectory_plain(xg, w),
                      inner=5),
            *_lstm_bound_ms(t, b, h, groups=SEEDS))
        times[f"lstm bwd {t}x{b}x{h}"] = (
            _graph_ms(lambda: lstm.backward(xg, w, ys, cs, dys, dcf)),
            _graph_ms(lambda: fused_lstm.lstm_recurrence_bwd_plain(
                xg, w, ys, cs, dys, dcf), inner=2),
            *_lstm_bound_ms(t, b, h, backward=True, groups=SEEDS))
    for b, n, d, adj in GROUPED_GAT[:2]:
        wh, f1, f2, a, _ = _gat_inputs(b, n, d, "per-graph", 0.3, 0)
        if adj == "grouped":
            a = a[::b // SEEDS].contiguous()
        bias = torch.rand(SEEDS, device="cuda")
        times[f"gat {b}x{n}x{d}"] = (
            _graph_ms(lambda: fused_gat.fused_gat.forward(wh, f1, f2, a,
                                                          bias, 0.1)),
            _graph_ms(lambda: fused_gat.fused_gat_plain(wh, f1, f2, a, bias,
                                                        0.1)),
            *_gat_bound_ms(b, n, d, adj, groups=SEEDS))
    for name, row in times.items():
        print(f"times [{SMI}]: grouped {name} G={SEEDS}: kernel {row[0]:.6f} "
              f"ms, plain {row[1]:.6f} ms, bound {row[2]:.6f} ms ({row[3]})")
    return times


@contextlib.contextmanager
def _record_seeds(sites, calls: list, choose=None):
    """Records the choices of ``owner.<name>``, for each ``(owner, name)``
    of ``sites``, in a vectorized forward: appends each call's ``(name,
    signature, choices (S, ...))``, the seeds' choices first, on the host.
    ``choose(*args)`` is a call's choice where it is not the output (a
    ReLU's mask)."""
    from torch._C import _functorch  # torch.func has no public unwrap

    def make(name, fn):
        def recorded(*args):
            out = fn(*args)
            chosen = out if choose is None else choose(*args)
            seeds = _functorch.get_unwrapped(chosen).movedim(
                _functorch.maybe_get_bdim(chosen), 0)
            calls.append((name, _signature(args), seeds.detach().cpu()))
            return out
        return recorded

    with _patched(sites, make):
        yield


def _seed_replay(method: str, recorded: list, s: int, signs: bool = False):
    """A :class:`_Replay` of ``method``'s top-k selections (and with
    ``signs`` its SIGNED masks) that replays seed ``s``'s choices of a
    vectorized run (recorded by :func:`_recording`) in that seed's
    sequential run; None for a method without either."""
    if method in RANKED:
        module, name = RANKED[method]
        sel = _Replay(module, (name,), _report_ranks)
    elif signs and method in SIGNED:
        sel = _signs(method)
    else:
        return None
    sel.card = [(name, sig, choices[s], None)
                for name, sig, choices in recorded]
    return sel


def _recording(method: str, recorded: list, signs: bool = False):
    """Records a vectorized forward's top-k selections (and with ``signs``
    its SIGNED masks) into ``recorded``."""
    if method in RANKED:
        return _record_seeds([RANKED[method]], recorded)
    if signs and method in SIGNED:
        return _record_seeds([(owner, name) for owner, name, _ in
                              SIGNED[method]], recorded,
                             choose=lambda *args: _input(args) > 0)
    return contextlib.nullcontext()


def _vectorized_term_gradients(engine: VectorizedEngine, x, y, keys):
    """``[{term: gradient as one flat fp64 vector}]`` a seed, as
    :func:`_term_gradients` for each seed's model, at the engine's state on
    one batch a seed, each seed's dropout keyed by its entry of ``keys``;
    the BatchNorm statistics are left as they were."""
    kept = {k: v.clone() for k, v in engine.buffers.items()}
    engine.model.train()

    def terms(params, buffers, xs, ys, key):
        with dropout_key(key):
            out = engine._forward(params, buffers, xs)
        pred, aux = out if isinstance(out, tuple) else (out, None)
        mse = torch.mean((pred - ys) ** 2)
        return (mse,) if aux is None else (mse, aux)

    values = torch.func.vmap(terms, randomness="error")(
        engine.params, engine.buffers, x, y,
        torch.tensor(keys, dtype=torch.int64, device=x.device))
    params = list(engine.params.values())
    out = [{} for _ in engine.seeds]
    for term, value in zip(("squared error", "auxiliary"), values):
        grads = torch.autograd.grad(value.sum(), params, retain_graph=True,
                                    allow_unused=True)
        for s in range(len(engine.seeds)):
            out[s][term] = torch.cat([
                (g[s] if g is not None else torch.zeros_like(p[s]))
                .detach().double().cpu().reshape(-1)
                for g, p in zip(grads, params)])
    # After the gradients: the backward of a train-mode BatchNorm reads the
    # statistics as the forward left them.
    for k, v in kept.items():
        engine.buffers[k].copy_(v)
    return out


# The methods whose vectorized run holds each term of its gradient at the
# weights of every one of its steps, against each seed's sequential model
# at the same weights (replaying the vectorized forward's top-k
# selections, or its SIGNED masks), in place of its free-running
# parameters: HAGCN's, whose first step's gradient terms meet TOL seed by
# seed (H100 80GB HBM3, 700 W) while Adam's normalised step on its
# cancelling entries (ROADMAP Queue 3 entry 6) carries 5 free-running
# steps 3.6e-3 from the sequential runs' parameters (each fp32 run ~3e-3
# from fp64) and its losses 29 times the tolerance from fp64 where a
# sequential run lies at 0.46 times. FC_STGNN's with its PE dropout on:
# each seed's 5 losses within 6.1e-6 of its sequential run's, but its
# parameters 7.8e-4 from the sequential run's and from fp64, the
# sequential run's 1.1e-4 from fp64 (H100 80GB HBM3, 700 W). Without its
# masks replayed, seed 2's third gradient lay 5.8e-5 off fp64 where the
# sequential run's lay 1.9e-8 off: one of its 3,050,400 (leaky) ReLU
# inputs, 8.1e-7 from 0, took the other side in the two runs (SIGNED; and
# one 8.4e-8 from 0 moved seed 1's second by 6.3e-6); replayed, every
# step's gradient met TOL, within 6.0e-8. Its losses are held at every
# step too (VECTORIZED_LOSSES_HELD).
VECTORIZED_GRADIENT_HELD = {"HAGCN": PARITY_STEPS, "FC_STGNN": PARITY_STEPS}
VECTORIZED_LOSSES_HELD = ("FC_STGNN",)


def _hold_vectorized_gradients(method, engine, model_fn, x, y, idx,
                               step: int) -> None:
    """Each term of each seed's gradient at the engine's state on its batch
    ``idx[s]``, vectorized against the seed's sequential model at the same
    weights on the card, the vectorized forward's top-k selections and
    SIGNED masks replayed, by :func:`_hold` (the fp64 witness on the CPU,
    replaying them too), each seed's dropout keyed as its step ``step``
    is."""
    keys = [step_key(s, 0, step - 1) for s in engine.seeds]
    ranked = []
    with _recording(method, ranked, signs=True):
        vec_terms = _vectorized_term_gradients(engine, x[idx], y[idx], keys)
    for s in range(len(engine.seeds)):
        sel = _seed_replay(method, ranked, s, signs=True)
        xs, ys = (t[idx[s]].cpu().numpy() for t in (x, y))
        state = engine.slice_state(s)

        def seeded(dtype=torch.float32, state=state):
            model = model_fn()
            model.load_state_dict(state)
            return model.to(dtype)

        with _during(sel, "replay"):
            seq = _term_gradients(seeded(), xs, ys, "cuda", key=keys[s])
        if sel:
            sel.report(method, f"seed {s}'s step {step} (the vectorized "
                               f"run's selections as the card's, the "
                               f"sequential model's as the CPU's)")

        @functools.cache
        def exact(sel=sel, seeded=seeded, xs=xs, ys=ys):
            with _plain_kernels(), _during(sel, "replay"):
                return _term_gradients(seeded(torch.float64), xs, ys, "cpu",
                                       torch.float64, key=keys[s])

        for term in seq:
            _hold(f"vectorized {method}: seed {s}'s step {step} gradient of "
                  f"the {term} term, vectorized vs sequential on the card "
                  f"({seq[term].numel()} values)", vec_terms[s][term],
                  seq[term], lambda term=term, exact=exact: exact()[term])



# The keyed dropout's cases: the dropout calls of the main path's training
# steps, (shape, p): FC_STGNN's PE dropout, STFA's attention (10 a step),
# GRU_CM's input and hidden dropouts, RGCNU's and LOGO's.
DROPOUT_CASES = [((100, 2, 14, 16), 0.1), ((2500, 14, 14), 0.2),
                 ((100, 50, 14, 7), 0.2), ((100, 50, 64), 0.2),
                 ((5000, 14, 32), 0.5), ((70, 100, 48), 0.2)]


def _dropout_inputs(shape, seed: int, groups: int = 1,
                    dtype=torch.float32):
    """x ``(groups * shape[0], ...)`` of unit normals (no zeros) on the
    card and the int64 keys of ``groups`` seeds' steps (a scalar at 1)."""
    gen = torch.Generator("cuda").manual_seed(seed)
    x = torch.randn((groups * shape[0], *shape[1:]), generator=gen,
                    device="cuda").to(dtype)
    keys = [step_key(g, 1, seed) for g in range(groups)]
    key = torch.tensor(keys if groups > 1 else keys[0], dtype=torch.int64,
                       device="cuda")
    return x, key


def _dropout_vs_plain() -> float:
    """The keyed dropout kernel at each case in fp32 and bf16, and
    grouped (one key a seed, SEEDS seeds, as a vectorized step calls it),
    one launch each: against its plain version on the same inputs on the
    card, the same zeros and values within 2^-22 |ref| in fp32 and 2^-7
    |ref| (one ulp) in bf16, as torch's division by a scalar on the card
    multiplies by its rounded reciprocal where the kernel divides; and
    bit for bit against the plain version on the CPU, which divides, so
    one key gives the same mask bits on the CPU and on the card. Returns
    the largest error against the plain version on the card."""
    kernel = keyed_dropout.keyed_dropout
    worst = 0.0
    for i, (shape, p) in enumerate(DROPOUT_CASES):
        for groups, dtype in ((1, torch.float32), (1, torch.bfloat16),
                              (SEEDS, torch.float32)):
            x, key = _dropout_inputs(shape, 800 + i, groups, dtype)
            before = kernel.launches
            got = kernel.forward(x, key, 3, p)
            torch.cuda.synchronize()
            ref = keyed_dropout.keyed_dropout_plain(x, key, 3, p)
            cpu = keyed_dropout.keyed_dropout_plain(x.cpu(), key.cpu(), 3, p)
            err = (got.float() - ref.float()).abs()
            rel = 2.0 ** (-22 if dtype == torch.float32 else -7)
            zeros = torch.equal(got == 0, ref == 0)
            ok = zeros and bool((err <= rel * ref.float().abs()).all())
            same = torch.equal(got.cpu(), cpu)
            print(f"keyed dropout {tuple(x.shape)} p={p} "
                  f"{str(dtype)[6:]}{f' G={groups}' if groups > 1 else ''}: "
                  f"kept {(got != 0).float().mean().item():.5f}; against "
                  f"the plain version on the card: zeros "
                  f"{'the same' if zeros else 'DIFFER'}, max_abs_err="
                  f"{err.max().item():.3e} (bound {rel:.3g} |ref|) "
                  f"{'ok' if ok else 'FAIL'}; against the plain version on "
                  f"the CPU {'bit-equal' if same else 'DIFFERENT'}")
            if kernel.launches - before != 1 or not ok or not same \
                    or not torch.isfinite(got).all():
                raise AssertionError(f"keyed dropout {tuple(x.shape)} p={p} "
                                     f"{dtype} G={groups} disagrees with "
                                     f"its plain version")
            worst = max(worst, err.max().item())
    return worst


def _dropout_bound_ms(numel: int, elt: int = 4) -> tuple:
    """Least time for the keyed dropout of ``numel`` elements of ``elt``
    bytes on an H100 SXM: x read and out written once at the HBM rate,
    against 20 integer operations an element (the two finalisers, the
    index product, the compare) at the fp32 rate, the table's nearest (it
    lists no int64 rate): bytes bind."""
    by_bytes = 2 * elt * numel / HBM_BYTES_PER_S * 1e3
    by_ops = 20 * numel / FP32_FLOP_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else \
        (by_ops, "operations")


def _dropout_times() -> dict:
    """{case: (kernel, plain, bound, bound by, None, torch's dropout)} in
    ms at each case in fp32, STFA's in bf16 and FC_STGNN's grouped over
    SEEDS seeds. No PyTorch call computes the keyed mask (library none);
    ``F.dropout``, which draws another mask, is timed beside it as a
    yardstick."""
    kernel = keyed_dropout.keyed_dropout
    cases = [(shape, p, 1, torch.float32) for shape, p in DROPOUT_CASES]
    cases += [(DROPOUT_CASES[1][0], DROPOUT_CASES[1][1], 1, torch.bfloat16),
              (DROPOUT_CASES[0][0], DROPOUT_CASES[0][1], SEEDS,
               torch.float32)]
    out = {}
    for i, (shape, p, groups, dtype) in enumerate(cases):
        x, key = _dropout_inputs(shape, 900 + i, groups, dtype)
        name = (f"{tuple(x.shape)} p={p} {str(dtype)[6:]}"
                + (f" G={groups}" if groups > 1 else ""))
        out[name] = (
            _graph_ms(lambda: kernel.forward(x, key, 3, p)),
            _graph_ms(lambda: keyed_dropout.keyed_dropout_plain(x, key, 3, p)),
            *_dropout_bound_ms(x.numel(), x.element_size()), None,
            _graph_ms(lambda: torch.nn.functional.dropout(x, p)))
        row = out[name]
        print(f"times [{SMI}]: keyed_dropout {name}: kernel {row[0]:.6f} "
              f"ms, plain {row[1]:.6f} ms, bound {row[2]:.6f} ms "
              f"({row[3]}), torch's F.dropout (another mask) {row[5]:.6f} ms")
    return out


def _dropout_step_times() -> dict:
    """A training step at batch 100 of the methods with the most dropout
    calls (STFA 10 a step, GRU_CM 3, FC_STGNN 1), each Dropout through the
    kernel, through its plain version (13 int64 launches a call) and
    through torch's ``F.dropout`` (another mask, as before the keyed
    masks), in turns: kernel, plain, torch, torch, plain, kernel. Host ms,
    median of 20; and one dropout call with its backward alone, host us a
    call. Returns both."""
    from gnn_rul_tpu_torch.nn import basic

    def plain(x, key, call, p, offset=0):
        return keyed_dropout.keyed_dropout_plain(x.contiguous(),
                                                 key.to(x.device), call, p,
                                                 offset)

    def torch_dropout(self, x):
        return torch.nn.functional.dropout(x, self.p, self.training)

    routes = {"kernel": None, "plain": plain, "torch": torch_dropout}

    def route(turn):
        """Patches nn/basic.py onto ``turn``'s route; returns the undo."""
        kept = basic.keyed_dropout, basic.Dropout.forward
        if turn == "plain":
            basic.keyed_dropout = routes[turn]
        elif turn == "torch":
            basic.Dropout.forward = routes[turn]

        def undo():
            basic.keyed_dropout, basic.Dropout.forward = kept
        return undo

    # One dropout call and its backward at STFA's (2500, 14, 14), host us
    # a call over 200 calls, synchronised at the end, in turns.
    drop = basic.Dropout(0.2).train()
    x = torch.randn(2500, 14, 14, device="cuda", requires_grad=True)
    g = torch.randn(2500, 14, 14, device="cuda")
    key = torch.full((), step_key(0, 1, 0), dtype=torch.int64, device="cuda")
    calls = {"kernel": [], "plain": [], "torch": []}
    for turn in ("kernel", "plain", "torch", "torch", "plain", "kernel"):
        undo = route(turn)
        try:
            with dropout_key(key):
                for _ in range(20):
                    drop(x).backward(g)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(200):
                    drop(x).backward(g)
                torch.cuda.synchronize()
            calls[turn].append((time.perf_counter() - t0) / 200 * 1e6)
        finally:
            undo()
    print(f"dropout call [{SMI}]: (2500, 14, 14) p=0.2 forward and "
          f"backward, host us a call: through the kernel {calls['kernel']}, "
          f"its plain version {calls['plain']}, torch's F.dropout "
          f"{calls['torch']} (in turns)")
    out = {"call_us": calls}
    for method in ("STFA", "GRU_CM", "FC_STGNN"):
        dataset, dataset_id = CELL[method]
        rng = np.random.default_rng(0)
        x = torch.from_numpy(_windows(dataset, rng, SERVE_BATCH)).cuda()
        y = torch.from_numpy(rng.uniform(size=(SERVE_BATCH, 1))
                             .astype(np.float32)).cuda()
        times = {"kernel": [], "plain": [], "torch": []}
        for turn in ("kernel", "plain", "torch", "torch", "plain", "kernel"):
            torch.manual_seed(0)
            engine = Engine(build_model(method, dataset, dataset_id),
                            get_algorithm_spec(method),
                            train_params(dataset, dataset_id, method))
            undo = route(turn)
            try:
                times[turn].append(_step_ms(engine, x, y))
            finally:
                undo()
        out[method] = times
        print(f"train step {method} [{SMI}]: dropout through the kernel "
              f"{times['kernel']} ms, its plain version {times['plain']} "
              f"ms, torch's F.dropout {times['torch']} ms (in turns)")
    return out


def _dropout_live(method: str) -> bool:
    """Whether ``method``'s model drops out in training (a Dropout above
    0)."""
    dataset, dataset_id = CELL[method]
    return any(isinstance(m, torch.nn.Dropout) and m.p > 0 for m in
               build_model(method, dataset, dataset_id).modules())


def _dropout_launches(method: str, what: str, forwards: int) -> int:
    """The keyed dropout kernel's launches since :func:`_reset` on a path
    of ``forwards`` training forwards of ``method``: one a dropout call
    forward and at most one backward, so at least ``forwards`` where the
    method drops out, and none where it does not."""
    launches = keyed_dropout.keyed_dropout.launches
    live = _dropout_live(method)
    if (launches >= forwards) if live else launches == 0:
        return launches
    raise AssertionError(f"{what} {method}: the keyed dropout kernel "
                         f"launched {launches} times over {forwards} "
                         f"training forwards"
                         + ("" if live else " of a model without dropout"))


def _vectorized(method: str) -> dict:
    """The main path of seed-parallel runs for ``method``: a
    VectorizedEngine of SEEDS seeds at the bank's train params against
    SEEDS sequential Engines from the same seeds, PARITY_STEPS steps at
    batch 100 on the card, each seed its own permutation of the same
    windows, dropout on, cuDNN deterministic. Every kernel launches once a
    call for all seeds: the launches of the vectorized steps and of one
    eval forward counted after :func:`_reset` (cuDNN's LSTM and GRU a call
    a seed, counted by ``library_rnn.calls``). Each seed's losses at every
    step and its parameters after the steps are held against its
    sequential run's at the 5-step tolerance (where they miss, both
    against the same steps in fp64 on the CPU, the vectorized run within
    the tolerance of them); a method of VECTORIZED_GRADIENT_HELD holds each
    term of its gradient at every step's weights instead. A ranked
    method's sequential runs replay the vectorized run's top-k selections.
    Dropout is on (the bank's rates; keyed, ``nn/basic.py``): seed s's
    masks are its sequential run's. Returns the launches."""
    torch.backends.cudnn.deterministic = True
    dataset, dataset_id = CELL[method]
    spec = get_algorithm_spec(method)
    tp = train_params(dataset, dataset_id, method)
    seeds = list(range(SEEDS))
    steps = PARITY_STEPS
    rng = np.random.default_rng(12)
    n = steps * SERVE_BATCH
    x = torch.from_numpy(_windows(dataset, rng, n)).cuda()
    y = torch.from_numpy(rng.uniform(size=(n, 1)).astype(np.float32)).cuda()

    def model_fn():
        return build_model(method, dataset, dataset_id)

    veng = VectorizedEngine(model_fn, spec, tp, seeds)
    perm = veng.permutations(n, 1, shuffle=True)
    batches = [perm[:, k * SERVE_BATCH:(k + 1) * SERVE_BATCH]
               for k in range(steps)]
    sequential = []
    for s in seeds:
        torch.manual_seed(s)
        sequential.append(Engine(model_fn(), spec, tp, seed=s))

    path = _path(method)
    rnn_layers = _library_rnn_layers(veng.model)
    held = method not in VECTORIZED_GRADIENT_HELD
    # The stacked state before each step, where the gradient is held.
    snapshots = []
    ranked = []
    _reset()
    calls = recurrent.library_rnn.calls
    v_losses = []
    with _recording(method, ranked):
        for idx in batches:
            if len(snapshots) < VECTORIZED_GRADIENT_HELD.get(method, 0):
                snapshots.append({k: t.detach().clone() for k, t in
                                  {**veng.params, **veng.buffers}.items()})
            v_losses.append(veng.train_step(x[idx], y[idx]).cpu().numpy())
    torch.cuda.synchronize()
    launches = {"steps": _counts(path.kernel),
                "library_rnn_steps": recurrent.library_rnn.calls - calls}
    _only_its_kernel(method, "vectorized steps")
    dropout = _dropout_launches(method, "vectorized steps", steps)
    _reset()
    calls = recurrent.library_rnn.calls
    preds = veng.evaluate(x[:SERVE_BATCH].cpu().numpy())
    torch.cuda.synchronize()
    launches["eval"] = _counts(path.kernel)[0]
    launches["library_rnn_eval"] = recurrent.library_rnn.calls - calls
    _only_its_kernel(method, "vectorized evaluation")
    want = {"steps": (path.train_per_forward * steps,
                      path.train_per_forward * path.bwd_per_call * steps),
            "library_rnn_steps": SEEDS * rnn_layers * steps,
            "eval": path.per_forward,
            "library_rnn_eval": SEEDS * rnn_layers}
    print(f"vectorized {method}: {SEEDS} seeds, launches per {steps} steps "
          f"(forward, backward) {launches['steps']}, per eval forward "
          f"{launches['eval']}; library_rnn calls "
          f"{launches['library_rnn_steps']} in the steps, "
          f"{launches['library_rnn_eval']} in the eval forward; keyed "
          f"dropout {dropout} in the steps (one a call for all seeds)")
    if launches != want:
        raise AssertionError(f"vectorized {method}: launches {launches}, "
                             f"expected {want}")
    launches["dropout"] = dropout
    if preds.shape != (SEEDS, SERVE_BATCH) or not np.isfinite(preds).all():
        raise AssertionError(f"vectorized {method}: predictions {preds.shape}")

    if snapshots:
        def load(state):
            with torch.no_grad():
                for name, t in {**veng.params, **veng.buffers}.items():
                    t.copy_(state[name])

        final = {k: t.detach().clone() for k, t in
                 {**veng.params, **veng.buffers}.items()}
        for k, snapshot in enumerate(snapshots):
            load(snapshot)
            _hold_vectorized_gradients(method, veng, model_fn, x, y,
                                       batches[k], step=k + 1)
        load(final)

    s_losses = []
    for s in seeds:
        sel = _seed_replay(method, ranked, s)
        with _during(sel, "replay"):
            s_losses.append([float(sequential[s].train_step(x[idx[s]],
                                                            y[idx[s]]))
                             for idx in batches])
        if sel:
            sel.report(method, f"seed {s}'s {steps} steps (the vectorized "
                               f"run's as the card's, the sequential run's "
                               f"as the CPU's)")
    s_losses = np.array(s_losses)
    v_losses = np.array(v_losses).T  # (S, steps)
    loss_ok = np.all(np.abs(v_losses - s_losses)
                     <= LOSS_ATOL + LOSS_RTOL * np.abs(s_losses))
    param_diff = 0.0
    for s in seeds:
        state = veng.slice_state(s)
        param_diff = max(param_diff, *(
            (state[k].double() - v.detach().cpu().double()).abs().max().item()
            for k, v in sequential[s].model.named_parameters()))
    print(f"vectorized {method}: {steps} steps at batch {SERVE_BATCH}, "
          f"largest |loss vectorized - sequential| "
          f"{np.abs(v_losses - s_losses).max():.3e} (losses "
          f"{v_losses[0].tolist()} for seed 0), max |param vectorized - "
          f"sequential| {param_diff:.3e}"
          + ("" if held else
             f"; the parameters not held: the gradient at the first "
             f"{VECTORIZED_GRADIENT_HELD[method]} step(s) is"
             + (", and the losses at every step" if method in
                VECTORIZED_LOSSES_HELD else "")))
    torch.backends.cudnn.deterministic = False
    if method in VECTORIZED_LOSSES_HELD and not loss_ok:
        raise AssertionError(f"vectorized {method}: the losses miss the "
                             f"sequential runs'")
    if not held or (loss_ok and param_diff < PARAM_MAX_DIFF):
        return launches
    # Where the vectorized run misses the sequential one, both against the
    # same steps in fp64 on the CPU: the vectorized run within the same
    # tolerance of them.
    off = {"vectorized": [0.0, 0.0], "sequential": [0.0, 0.0]}
    for s in seeds:
        torch.manual_seed(s)
        e64 = Engine(model_fn().double(), spec, tp, seed=s, device="cpu")
        with _plain_kernels(), _during(_seed_replay(method, ranked, s),
                                       "replay"):
            losses64 = np.array([float(e64.train_step(
                x[idx[s]].cpu().double(), y[idx[s]].cpu().double()))
                for idx in batches])
        state = veng.slice_state(s)
        for run, losses, params in (
                ("vectorized", v_losses[s], state),
                ("sequential", s_losses[s],
                 {k: v.detach().cpu() for k, v in
                  sequential[s].model.named_parameters()})):
            off[run][0] = max(off[run][0], float(np.max(
                np.abs(losses - losses64)
                / (LOSS_ATOL + LOSS_RTOL * np.abs(losses64)))))
            off[run][1] = max(off[run][1], *(
                (params[k].double() - p.detach()).abs().max().item()
                for k, p in e64.model.named_parameters()))
    print(f"vectorized {method}: missed the sequential runs; against the "
          f"same steps in fp64 on the CPU, the vectorized losses at "
          f"{off['vectorized'][0]:.3f} of the tolerance and its parameters "
          f"{off['vectorized'][1]:.3e} off, the sequential "
          f"{off['sequential'][0]:.3f} and {off['sequential'][1]:.3e}")
    if off["vectorized"][0] > 1 or not off["vectorized"][1] < PARAM_MAX_DIFF:
        raise AssertionError(f"vectorized {method}: misses the sequential "
                             f"runs and the same steps in fp64")
    return launches


# Sequential epochs timed against a vectorized one: SEEDS times their mean
# stands for the SEEDS sequential epochs (each seed's epoch is the same
# work). One is timed: a timing-depth cut, never a check (PERF.md §4).
SEQUENTIAL_TIMED = 1


def _vectorized_times(method: str, data: _Processed) -> dict:
    """One vectorized epoch of SEEDS seeds against SEEDS sequential epochs,
    one a seed (SEEDS times the mean of SEQUENTIAL_TIMED timed ones), of
    the same windows, host clock, after each engine's warm-up steps (a
    full batch and the remainder batch); samples/s over all seeds; the
    card's busy share of a traced vectorized step."""
    dataset, dataset_id = CELL[method]
    spec = get_algorithm_spec(method)
    tp = train_params(dataset, dataset_id, method)
    shuffle = get_dataset_config(dataset).shuffle
    n = len(data.train_x)
    rem = n % SERVE_BATCH

    def model_fn():
        return build_model(method, dataset, dataset_id)

    seq_s = []
    for s in range(SEQUENTIAL_TIMED):
        torch.manual_seed(s)
        engine = Engine(model_fn(), spec, tp, seed=s)
        xd, yd = engine._device_data(data.train_x, data.train_y)
        engine.train_step(xd[:SERVE_BATCH], yd[:SERVE_BATCH])
        if rem:
            engine.train_step(xd[:rem], yd[:rem])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.run_epoch(data.train_x, data.train_y, 1, shuffle=shuffle)
        seq_s.append(time.perf_counter() - t0)
    veng = VectorizedEngine(model_fn, spec, tp, list(range(SEEDS)))
    xd, yd = veng._device_data(data.train_x, data.train_y)
    idx = veng.permutations(n, 1, shuffle=False)
    xb, yb = xd[idx[:, :SERVE_BATCH]], yd[idx[:, :SERVE_BATCH]]
    step_ms = _step_ms(veng, xb, yb, warmup=2, reps=10)
    if rem:
        veng.train_step(xd[idx[:, :rem]], yd[idx[:, :rem]])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    veng.run_epoch(data.train_x, data.train_y, 1, shuffle=shuffle)
    vec_s = time.perf_counter() - t0
    busy_us, traced_us = _profile(f"vectorized step {method} ({SEEDS} seeds)",
                                  lambda: veng.train_step(xb, yb), step_ms,
                                  "step", reps=5)
    seq_total = SEEDS * statistics.mean(seq_s)
    out = {"vectorized_epoch_s": vec_s, "sequential_epochs_s": seq_total,
           "vectorized_samples_per_s": SEEDS * n / vec_s,
           "sequential_samples_per_s": SEEDS * n / seq_total,
           "vectorized_step_ms": step_ms,
           "vectorized_step_busy_share": busy_us / traced_us}
    print(f"vectorized times {method} [{SMI}]: {SEEDS} seeds x {n} windows; "
          f"one vectorized epoch {vec_s:.4f} s, "
          f"{out['vectorized_samples_per_s']:.1f} samples/s all seeds; "
          f"{SEEDS} sequential epochs {seq_total:.4f} s ({SEEDS} x the mean "
          f"of seeds {list(range(SEQUENTIAL_TIMED))}'s: "
          + ", ".join(f"{t:.4f}" for t in seq_s) + "), "
          f"{out['sequential_samples_per_s']:.1f} samples/s; "
          f"{seq_total / vec_s:.3f}x; a vectorized step {step_ms:.4f} ms "
          f"(median of 10), the card busy {busy_us:.1f} us of a traced "
          f"step's {traced_us:.1f} ({100 * busy_us / traced_us:.1f}%)")
    return out



# Phase "bf16" (slice 14): each kernel's bf16 instantiation against its
# plain bf16 version (reads bf16, computes in fp32, rounds once) and
# against its own fp32 instantiation on the up-cast inputs, at the shapes
# the fp32 phases use, and one G = 5 grouped case for each operator.
BF16 = torch.bfloat16
# The bf16 LSTM backward recomputes its gates from the stored bf16 ys and
# cs, the fp32 one from fp32 ys and cs: the two backward trajectories part
# by the rounding of the saved state, carried along T. Its bound against
# the fp32 kernel is 2^-8 |ref| + 2^-5 max |ref| (the measured error is
# printed beside it).
LSTM_BWD_VS_FP32 = 2.0 ** -5
BF16_GNN = ((100, 28, 16, 16, 1), (1000, 28, 16, 16, 1),
            (5 * 100, 28, 16, 16, 5))
BF16_LSTM = ((100, 70, 48, 1), (1400, 5, 120, 1), (100, 200, 30, 1),
             (100, 5 * 70, 48, 5))
BF16_GAT = ((100, 14, 64, "per-graph", 1), (2500, 14, 5, "shared", 1),
            (5 * 100, 14, 64, "per-graph", 5))


def _bf16_ulp(v: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp at |v| (fp32): 2^(floor(log2 |v|) - 7)."""
    a = v.abs().clamp_min(torch.finfo(torch.float32).tiny)
    return torch.exp2(torch.floor(torch.log2(a)) - 7)


def _hold_bf16(what: str, got, want, spread: float = 0.0):
    """``got`` (bf16) against ``want``, compared in fp32. A bf16 ``want``
    (the plain bf16 version, itself rounded) within one bf16 ulp of |want|
    plus 1e-6; an fp32 ``want`` (the fp32 kernel: one rounding apart)
    within 2^-8 |want| + 1e-6, plus ``spread`` times max |want| where
    given. Prints the largest error and the count of elements not equal
    to the reference rounded to bf16; returns (largest error, count)."""
    g, w = got.float(), want.float()
    err = (g - w).abs()
    if want.dtype == BF16:
        bound = _bf16_ulp(w) + 1e-6
        how = "one bf16 ulp + 1e-6"
    else:
        bound = 2.0 ** -8 * w.abs() + 1e-6 + spread * w.abs().max()
        how = "2^-8 |ref| + 1e-6" + (f" + {spread:g} max|ref|" if spread
                                     else "")
    ok = bool((err <= bound).all()) and bool(torch.isfinite(g).all())
    off = int((got != want.to(BF16)).sum())
    print(f"{what}: max_abs_err={err.max().item():.3e} ({how}), {off} of "
          f"{err.numel()} elements off the reference rounded to bf16 "
          f"{'ok' if ok else 'FAIL'}")
    if got.dtype != BF16 or not ok:
        raise AssertionError(f"{what}: {got.dtype}, or beyond the bound")
    return err.max().item(), off


def _bf16_gnn_case(b, n, d, f, groups, seed):
    kernel = fused_gnn.fused_dot_graph_spmm
    h, x, mask = _fused_inputs(b, n, d, f, seed)
    if groups > 1:
        mask = torch.stack([mask * (1.0 - 0.1 * g) for g in range(groups)])
    g = torch.randn(x.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(seed))
    hb, xb, mb, gb = (t.to(BF16).contiguous() for t in (h, x, mask, g))
    up = [t.float() for t in (hb, xb, mb, gb)]
    before = (kernel.bf16_launches, kernel.bf16_bwd_launches)
    out = kernel.forward(hb, xb, mb)
    dh, dx, dmask = kernel.backward(hb, xb, mb, gb, need_dmask=True)
    launched = (kernel.bf16_launches - before[0],
                kernel.bf16_bwd_launches - before[1])
    if launched != (1, fused_gnn.bwd_launches_per_call(n, d, f)):
        raise AssertionError(f"bf16 dot graph launched {launched}")
    plain = fused_gnn.fused_dot_graph_spmm_plain(hb, xb, mb)
    p_bwd = fused_gnn.fused_dot_graph_spmm_bwd_plain(hb, xb, mb, gb)
    ref = kernel.forward(*up[:3])
    r_bwd = kernel.backward(*up, need_dmask=True)
    torch.cuda.synchronize()
    shape = f"B={b} N={n} D={d} F={f} G={groups}"
    errs = [_hold_bf16(f"bf16 dot graph {shape} out vs plain bf16", out,
                       plain)[0]]
    _hold_bf16(f"bf16 dot graph {shape} out vs fp32 kernel", out, ref)
    bwd = []
    for name, got, want, r in zip(("dh", "dx", "dmask"), (dh, dx, dmask),
                                  p_bwd, r_bwd):
        bwd.append(_hold_bf16(f"bf16 dot graph bwd {shape} {name} vs plain "
                              f"bf16", got, want)[0])
        _hold_bf16(f"bf16 dot graph bwd {shape} {name} vs fp32 kernel", got,
                   r)
    return max(errs), max(bwd)


def _bf16_lstm_case(t, b, h, groups, seed):
    kernel = fused_lstm.lstm_recurrence
    xg, w, dys, dcf = _lstm_inputs(t, b, h, seed)
    if groups > 1:
        w = torch.stack([_lstm_inputs(1, 1, h, seed + g)[1]
                         for g in range(groups)])
    xb, wb, dyb, dcb = (a.to(BF16).contiguous() for a in (xg, w, dys, dcf))
    before = (kernel.bf16_launches, kernel.bf16_bwd_launches)
    ys, cs, c_fin = kernel.forward(xb, wb)
    dxg, dw = kernel.backward(xb, wb, ys, cs, dyb, dcb)
    launched = (kernel.bf16_launches - before[0],
                kernel.bf16_bwd_launches - before[1])
    if launched != (1, fused_lstm.BWD_LAUNCHES_PER_CALL):
        raise AssertionError(f"bf16 LSTM launched {launched}")
    p_ys, p_cs = fused_lstm.lstm_trajectory_plain(xb, wb)
    p_dxg, p_dw = fused_lstm.lstm_recurrence_bwd_plain(xb, wb, ys, cs, dyb,
                                                       dcb)
    r_ys, r_cs, r_fin = kernel.forward(xb.float(), wb.float())
    r_dxg, r_dw = kernel.backward(xb.float(), wb.float(), r_ys, r_cs,
                                  dyb.float(), dcb.float())
    torch.cuda.synchronize()
    plan = kernel.plan(h, b)
    shape = f"T={t} B={b} H={h} G={groups}" + (
        f" (cluster of {plan['cluster']})" if plan["cluster"] > 1 else "")
    fwd, bwd = [], []
    for name, got, want, r in (("ys", ys, p_ys, r_ys), ("cs", cs, p_cs, r_cs),
                               ("c_fin", c_fin, p_cs[-1], r_fin)):
        fwd.append(_hold_bf16(f"bf16 lstm {shape} {name} vs plain bf16", got,
                              want)[0])
        _hold_bf16(f"bf16 lstm {shape} {name} vs fp32 kernel", got, r)
    for name, got, want, r in (("dxg", dxg, p_dxg, r_dxg),
                               ("dw", dw, p_dw, r_dw)):
        bwd.append(_hold_bf16(f"bf16 lstm bwd {shape} {name} vs plain bf16",
                              got, want)[0])
        _hold_bf16(f"bf16 lstm bwd {shape} {name} vs fp32 kernel (its own "
                   f"fp32 trajectory)", got, r, spread=LSTM_BWD_VS_FP32)
    return max(fwd), max(bwd)


def _bf16_gat_case(b, n, d, adj, groups, seed):
    kernel = fused_gat.fused_gat
    args = list(_gat_inputs(b, n, d, adj, 0.3, seed))
    if groups > 1:
        args[4] = torch.linspace(-0.4, 0.4, groups, device="cuda")
    ab = [t.to(BF16).contiguous() for t in args]
    before = kernel.bf16_launches
    out = kernel.forward(*ab, 0.1)
    if kernel.bf16_launches - before != 1:
        raise AssertionError("bf16 attention launched no kernel")
    plain = fused_gat.fused_gat_plain(*ab, 0.1)
    ref = kernel.forward(*(t.float() for t in ab), 0.1)
    torch.cuda.synchronize()
    shape = f"B={b} N={n} D={d} adj={adj} G={groups}"
    err = _hold_bf16(f"bf16 gat {shape} vs plain bf16", out, plain)[0]
    _hold_bf16(f"bf16 gat {shape} vs fp32 kernel", out, ref)
    return err


def _bf16_vs_plain() -> dict:
    """Every kernel's bf16 instantiation at BF16_GNN, BF16_LSTM and BF16_GAT
    against its plain bf16 version and its fp32 kernel, by
    :func:`_hold_bf16`; each call must launch the bf16 kernels it reports.
    Returns the largest errors against the plain versions."""
    errs = {"gnn": [0.0, 0.0], "lstm": [0.0, 0.0], "gat": 0.0}
    for i, case in enumerate(BF16_GNN):
        errs["gnn"] = [max(a, e) for a, e in
                       zip(errs["gnn"], _bf16_gnn_case(*case, seed=700 + i))]
    for i, case in enumerate(BF16_LSTM):
        errs["lstm"] = [max(a, e) for a, e in
                        zip(errs["lstm"], _bf16_lstm_case(*case, 710 + i))]
    for i, case in enumerate(BF16_GAT):
        errs["gat"] = max(errs["gat"], _bf16_gat_case(*case, seed=720 + i))
    return errs



# The methods trained at bf16 in phase "bf16" (one method on each kernel),
# those served at bf16 (every method on a kernel), and the bounds the bf16
# runs are held to. Serving, bf16 against fp32: the JAX package's bound
# for its bf16 forward against fp32 (tests/test_bf16.py:80-81). Training,
# the card's 5 bf16 steps against the CPU's, both bf16: the largest
# |card - CPU| / |CPU| of the 5 losses, a limit for each method set
# between two readings (H100 80GB HBM3, 700 W; PERF.md §6): the bf16 gap
# over 4 seeds of weights and batches (FC_STGNN 1.068e-3, LOGO 3.343e-4,
# STAGNN 1.990e-4), and the fp32 steps held against the same CPU bf16
# steps at the inputs used here (3.103e-3, 2.567e-3, 6.222e-4). The fp32
# steps run beside the bf16 ones as a control and must miss the limit, so
# a path that stayed fp32 would fail.
BF16_TRAINED = ("FC_STGNN", "LOGO", "STAGNN")
BF16_SERVED = ("FC_STGNN", "LOGO", "STAGNN", "STFA", "HAGCN", "GAT_LSTM",
               "GDAGDL", "LOGO_bearing")
BF16_LOSS_RTOL = {"FC_STGNN": 1.8e-3, "LOGO": 9e-4, "STAGNN": 3.5e-4}
BF16_SERVE_RTOL, BF16_SERVE_ATOL = 0.1, 0.05


def _bf16_counts(kernel):
    """The bf16 instantiations' (forward, backward) launches."""
    if kernel is None:
        return 0, 0
    return kernel.bf16_launches, getattr(kernel, "bf16_bwd_launches", 0)


def _all_bf16(method: str, what: str) -> tuple:
    """The launches of ``method``'s kernel since :func:`_reset`, each one
    of its bf16 instantiation (no fp32 launch on a bf16 path), and no
    other wrapper's."""
    kernel = _path(method).kernel
    counts = _counts(kernel)
    if _bf16_counts(kernel) != counts:
        raise AssertionError(f"{what} {method}: launches {counts}, of them "
                             f"bf16 {_bf16_counts(kernel)}")
    _only_its_kernel(method, what)
    return counts


def _fp32_state(method: str, what: str, state: dict, optimizer) -> None:
    """Master parameters, BatchNorm statistics and Adam's moments fp32."""
    bad = [k for k, v in state.items()
           if v.is_floating_point() and v.dtype != torch.float32]
    bad += [f"adam {k}" for st in optimizer["state"].values()
            for k, v in st.items()
            if torch.is_tensor(v) and v.dim() and v.dtype != torch.float32]
    if bad:
        raise AssertionError(f"{what} {method}: not fp32: {bad[:5]}")


def _bf16_runs(method: str, seed: int = 0):
    """PARITY_STEPS steps of ``method`` from the weights of ``seed`` on the
    batches of 100 of ``2 + seed``, dropout off: the losses at bf16 on the
    card, at bf16 on the CPU and at fp32 on the card (the control), and
    the card's bf16 engine, the launches of its steps counted after
    :func:`_reset`."""
    dataset, dataset_id = CELL[method]
    spec = get_algorithm_spec(method)
    tp = train_params(dataset, dataset_id, method)
    torch.manual_seed(seed)
    sd = build_model(method, dataset, dataset_id).state_dict()

    def engine(device, precision="bf16"):
        model = build_model(method, dataset, dataset_id)
        model.load_state_dict(sd)
        return Engine(_no_dropout(model), spec, tp, device=device,
                      precision=precision)

    rng = np.random.default_rng(2 + seed)
    xs = _windows(dataset, rng, PARITY_STEPS * SERVE_BATCH)
    xs = xs.reshape(PARITY_STEPS, SERVE_BATCH, *xs.shape[1:])
    ys = rng.uniform(size=(PARITY_STEPS, SERVE_BATCH, 1)).astype(np.float32)
    on_card = engine("cuda")
    _reset()
    card = _steps(on_card, xs, ys, "cuda")
    torch.cuda.synchronize()
    launches = _all_bf16(method, "bf16 steps")
    cpu = _steps(engine("cpu"), xs, ys, "cpu")
    control = _steps(engine("cuda", "fp32"), xs, ys, "cuda")
    return card, cpu, control, on_card, launches


def _bf16_readings(seeds=range(4)) -> None:
    """The two readings BF16_LOSS_RTOL lies between, for each trained
    method over ``seeds``: the largest |card - CPU| / |CPU| of the bf16
    losses, and of the fp32 control's against the CPU's bf16. Not a phase
    of :func:`main`; run it as ``python3 -c "import chip_smoke as c;
    c._device(); c._build(); c._bf16_readings()"``."""
    for method in BF16_TRAINED:
        for seed in seeds:
            card, cpu, control, _, _ = _bf16_runs(method, seed)
            print(f"bf16 readings {method} seed {seed} [{SMI}]: bf16 card "
                  f"against CPU {(np.abs(card - cpu) / np.abs(cpu)).max():.3e}"
                  f", fp32 card against the CPU's bf16 "
                  f"{(np.abs(control - cpu) / np.abs(cpu)).max():.3e}",
                  flush=True)


def _bf16_steps(method: str) -> np.ndarray:
    """PARITY_STEPS bf16 steps on the card and on the CPU from the same
    weights on the same batches of 100, dropout off: finite losses, held
    card against CPU at BF16_LOSS_RTOL, which the same steps in fp32 on
    the card (the control) must miss; fp32 state; every launch a bf16
    one."""
    card, cpu, control, on_card, launches = _bf16_runs(method)
    path = _path(method)
    want = (path.train_per_forward * PARITY_STEPS,
            path.train_per_forward * path.bwd_per_call * PARITY_STEPS)
    _fp32_state(method, "bf16 steps", on_card.model.state_dict(),
                on_card.optimizer.state_dict())
    rel = np.abs(card - cpu) / np.abs(cpu)
    rel32 = np.abs(control - cpu) / np.abs(cpu)
    limit = BF16_LOSS_RTOL[method]
    print(f"bf16 steps {method}: {PARITY_STEPS} steps at batch "
          f"{SERVE_BATCH}, losses card {card.tolist()}, CPU {cpu.tolist()} "
          f"(largest |card - CPU| / |CPU| {rel.max():.3e}, limit {limit:g}; "
          f"the fp32 steps on the card {control.tolist()}, "
          f"{rel32.max():.3e} from the CPU's bf16); launches {launches}, "
          f"all bf16")
    if launches != want:
        raise AssertionError(f"bf16 steps {method}: launches {launches}, "
                             f"expected {want}")
    if not np.isfinite(card).all() or rel.max() > limit:
        raise AssertionError(f"bf16 steps {method}: card against CPU")
    if rel32.max() <= limit:
        raise AssertionError(f"bf16 steps {method}: the fp32 control "
                             f"meets the bf16 limit, which then tells "
                             f"bf16 from fp32 no more")
    return card


def _bf16_epoch(method: str, data: _Processed) -> tuple:
    """``cli.main --precision bf16`` trains one epoch of ``method``: its
    launches those of the fp32 epoch (:func:`_train_entry_point`), every
    one bf16; a finite loss; checkpoint.pt fp32, marked bf16."""
    dataset, dataset_id = CELL[method]
    save_dir = os.path.join(os.path.dirname(data.root), "logs_bf16")
    _reset()
    cli.main(["--GNN_method", method, "--dataset", dataset, "--dataset_id",
              dataset_id, "--data_path", data.root, "--save_dir", save_dir,
              "--epochs", "1", "--num_runs", "1", "--precision", "bf16"])
    torch.cuda.synchronize()
    launches = _all_bf16(method, "bf16 epoch")
    drop = keyed_dropout.keyed_dropout
    dropout = (drop.launches, drop.bf16_launches)
    DROPOUT_EPOCH_BF16[method] = dropout[1]
    path = _path(method)
    steps = -(-len(data.train_x) // SERVE_BATCH)
    evals = sum(-(-len(x) // SERVE_BATCH) for x in data.tests.values())
    want = (path.train_per_forward * steps + path.per_forward * evals,
            path.train_per_forward * path.bwd_per_call * steps)
    run_dir = os.path.join(save_dir, "GNN_RUL", "run_1", f"{method}_run_0")
    with open(os.path.join(run_dir, "logs_run_0.log")) as f:
        losses = [float(v) for v in re.findall(r"loss\t: (\S+)", f.read())]
    ckpt = torch.load(os.path.join(run_dir, "checkpoint.pt"),
                      map_location="cpu", weights_only=True)
    _fp32_state(method, "bf16 epoch", ckpt["model_dict"], ckpt["optimizer"])
    print(f"bf16 epoch {method}: cli.main --precision bf16, 1 epoch of "
          f"{len(data.train_x)} windows, loss {losses}; launches {launches} "
          f"(the fp32 epoch's {want}), all bf16; keyed dropout "
          f"{dropout[0]} (the fp32 epoch's {DROPOUT_EPOCH[method]}), "
          f"{dropout[1]} of them bf16; checkpoint.pt fp32, precision "
          f"{ckpt['precision']!r}")
    if launches != want or len(losses) != 1 or not np.isfinite(losses[0]) \
            or ckpt["precision"] != "bf16" \
            or dropout != (DROPOUT_EPOCH[method],) * 2:
        raise AssertionError(f"bf16 epoch {method}")
    return launches


def _bf16_train_times(method: str, data: _Processed) -> dict:
    """A training step at batch 100 and one epoch, fp32 and bf16 in turns
    (fp32, bf16, bf16, fp32 for the steps), on one card; the ratios of
    bf16's samples/s to fp32's fill ``train/precision.py``."""
    dataset, dataset_id = CELL[method]
    xb = torch.from_numpy(data.train_x[:SERVE_BATCH]).cuda()
    yb = torch.from_numpy(data.train_y[:SERVE_BATCH]).cuda()
    engines = {}
    for precision in ("fp32", "bf16"):
        torch.manual_seed(0)
        engines[precision] = Engine(
            build_model(method, dataset, dataset_id),
            get_algorithm_spec(method),
            train_params(dataset, dataset_id, method), precision=precision)
    step = {"fp32": [], "bf16": []}
    for precision in ("fp32", "bf16", "bf16", "fp32"):
        step[precision].append(_step_ms(engines[precision], xb, yb))
    epoch = {}
    rem = len(data.train_x) % SERVE_BATCH
    for precision, engine in engines.items():
        engine._device_data(data.train_x, data.train_y)
        if rem:
            engine.train_step(xb[:rem], yb[:rem])
        t0 = time.perf_counter()
        engine.run_epoch(data.train_x, data.train_y, 1,
                         shuffle=get_dataset_config(dataset).shuffle)
        epoch[precision] = len(data.train_x) / (time.perf_counter() - t0)
    out = {"step_ms": {k: statistics.median(v) for k, v in step.items()},
           "epoch_samples_per_s": epoch,
           "ratio": epoch["bf16"] / epoch["fp32"]}
    print(f"bf16 train times {method} [{SMI}]: step at batch {SERVE_BATCH} "
          f"fp32 {step['fp32']} ms, bf16 {step['bf16']} ms (in turns); one "
          f"epoch fp32 {epoch['fp32']:.1f}, bf16 {epoch['bf16']:.1f} "
          f"samples/s, bf16/fp32 {out['ratio']:.4f}")
    return out


def _bf16_serve(method: str) -> int:
    """Requests of 100 and 1000 through ``serving_model(precision="bf16")``
    on the card, every launch a bf16 one, against the fp32 serving model on
    the card at the same batch, at the JAX package's bf16 forward bound.
    Returns the launches of the request of 100."""
    dataset, dataset_id = CELL[method]
    sd = _seeded_state_dict(method)
    models = {p: serving_model(method, dataset, dataset_id, sd, precision=p)
              for p in ("fp32", "bf16")}
    rng = np.random.default_rng(31)
    first = None
    for n in (SERVE_BATCH, 1000):
        x = _windows(dataset, rng, n)
        _reset()
        got = models["bf16"](x)
        torch.cuda.synchronize()
        launches = _all_bf16(method, f"bf16 request of {n}")
        first = launches[0] if first is None else first
        want = models["fp32"](x)
        diff = np.abs(got - want)
        ok = bool(np.all(diff <= BF16_SERVE_ATOL
                         + BF16_SERVE_RTOL * np.abs(want)))
        print(f"bf16 serve {method}: a request of {n}, {got.dtype} "
              f"{got.shape}, {launches[0]} launches, all bf16; against fp32 "
              f"on the card max |diff| {diff.max():.3e} (rtol="
              f"{BF16_SERVE_RTOL}, atol={BF16_SERVE_ATOL}) "
              f"{'ok' if ok else 'FAIL'}")
        if got.dtype != np.float32 or got.shape != (n,) \
                or not np.isfinite(got).all() or not ok or not launches[0]:
            raise AssertionError(f"bf16 serve {method}")
    return first


def _bf16_artifact(tmp: str) -> int:
    """FC_STGNN's bf16 artifact (symbolic batch, traced on the CPU), saved,
    loaded on the card: a request of 100 served as the live bf16 model
    serves it, through the bf16 kernel. Returns its launches."""
    sd = _seeded_state_dict("FC_STGNN")
    meta, program = export.export_serving("FC_STGNN", "CMAPSS", "FD001", sd,
                                          precision="bf16")
    path = export.save_artifact(os.path.join(tmp, "fc_stgnn_bf16.pt2"),
                                meta, program)
    art = export.load_artifact(path)
    live = serving_model("FC_STGNN", "CMAPSS", "FD001", sd,
                         precision="bf16")
    x = _windows("CMAPSS", np.random.default_rng(32), SERVE_BATCH)
    _reset()
    got = art(x)
    torch.cuda.synchronize()
    launches = _all_bf16("FC_STGNN", "bf16 artifact")
    want = live(x)
    diff = float(np.abs(got - want).max())
    nodes = _op_nodes(art.program)
    print(f"bf16 artifact FC_STGNN: {os.path.getsize(path)} bytes, "
          f"precision {meta['precision']!r}, operator nodes {nodes}; a "
          f"request of {SERVE_BATCH}: {launches[0]} launches, all bf16, max "
          f"|artifact - live bf16| {diff:.3e}")
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=2.0 ** -7)
    return launches[0]


def _cudnn_bf16_lstm() -> None:
    """Whether cuDNN takes a bf16 LSTM on this card: torch's check, and the
    kernels a bf16 ``torch.nn.LSTM`` forward runs."""
    lib = torch.nn.LSTM(48, 48, bidirectional=True,
                        batch_first=True).cuda().to(BF16)
    x = torch.randn(70, 100, 48, device="cuda", dtype=BF16)
    lib(x)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        lib(x)
        torch.cuda.synchronize()
    names = sorted({e.key[:60] for e in prof.key_averages()
                    if e.device_type == torch.autograd.DeviceType.CUDA})
    print(f"cuDNN bf16 LSTM [{SMI}]: torch.backends.cudnn.is_acceptable "
          f"{torch.backends.cudnn.is_acceptable(x)}, a bf16 nn.LSTM forward "
          f"runs {names[:8]}")


def _bf16_kernel_times() -> dict:
    """Each kernel's bf16 and fp32 instantiations in turns (fp32, bf16,
    bf16, fp32; CUDA graphs), the plain bf16 version, the bound at 2-byte
    operands and, for the LSTM, a bf16 ``torch.nn.LSTM`` (PyTorch's own
    CUDA RNN: cuDNN takes no bf16, :func:`_cudnn_bf16_lstm`), at the main
    shapes:
    {name: (bf16 ms, plain ms, bound ms, bound by, library ms, fp32 ms)}."""
    out = {}
    gnn = fused_gnn.fused_dot_graph_spmm
    for shape in KERNEL_CASES[:2]:
        h, x, mask = _fused_inputs(*shape, seed=0)
        g = torch.randn(x.shape, device="cuda",
                        generator=torch.Generator("cuda").manual_seed(0))
        args = {"fp32": (h, x, mask, g),
                "bf16": tuple(t.to(BF16) for t in (h, x, mask, g))}
        for part, call, plain in (
                ("fwd", lambda a: gnn.forward(*a[:3]),
                 lambda a: fused_gnn.fused_dot_graph_spmm_plain(*a[:3])),
                ("bwd", lambda a: gnn.backward(*a),
                 lambda a: fused_gnn.fused_dot_graph_spmm_bwd_plain(*a))):
            out[f"gnn {part} {shape}"] = _bf16_row(
                f"fused_dot_graph_spmm{'_bwd' if part == 'bwd' else ''} "
                f"B={shape[0]} N={shape[1]} D={shape[2]} F={shape[3]}",
                lambda p: _graph_ms(lambda: call(args[p])),
                _graph_ms(lambda: plain(args["bf16"])),
                _bound_ms(*shape, backward=part == "bwd", elt=2), None)
    lstm = fused_lstm.lstm_recurrence
    for t, b, h in ((100, 70, 48), (1400, 5, 120), (100, 200, 30)):
        xg, w, dys, dcf = _lstm_inputs(t, b, h, seed=0)
        args = {"fp32": (xg, w, dys, dcf),
                "bf16": tuple(a.to(BF16) for a in (xg, w, dys, dcf))}
        saved = {p: lstm.forward(*args[p][:2])[:2] for p in args}
        calls = max(1, min(50, 20000 // t))
        lib = torch.nn.LSTM(h, h, bidirectional=True,
                            batch_first=True).cuda().to(BF16)
        xl = torch.randn(b, t, h, device="cuda", dtype=BF16,
                         requires_grad=True)
        gl = torch.randn(b, t, 2 * h, device="cuda", dtype=BF16)
        lib_inner = max(1, min(10, 2000 // t))

        def lib_fwd():
            with torch.no_grad():
                lib(xl)

        lib_f = _event_ms(lib_fwd, inner=lib_inner)
        lib_train = _event_ms(lambda: lib(xl)[0].backward(gl),
                              inner=lib_inner) - _event_ms(
            lambda: lib(xl), inner=lib_inner)
        out[f"lstm fwd {(t, b, h)}"] = _bf16_row(
            f"lstm_recurrence T={t} B={b} H={h}",
            lambda p: _graph_ms(lambda: lstm.forward(*args[p][:2]),
                                inner=calls),
            _graph_ms(lambda: fused_lstm.lstm_trajectory_plain(
                *args["bf16"][:2]), inner=max(1, 500 // t),
                reps=21 if t <= 2000 else 3),
            _lstm_bound_ms(t, b, h, elt=2), lib_f)
        out[f"lstm bwd {(t, b, h)}"] = _bf16_row(
            f"lstm_recurrence_bwd T={t} B={b} H={h}",
            lambda p: _graph_ms(lambda: lstm.backward(
                *args[p][:2], *saved[p], *args[p][2:]), inner=calls),
            _graph_ms(lambda: fused_lstm.lstm_recurrence_bwd_plain(
                *args["bf16"][:2], *saved["bf16"], *args["bf16"][2:]),
                inner=max(1, 500 // t // 3), reps=21 if t <= 2000 else 3),
            _lstm_bound_ms(t, b, h, backward=True, elt=2), lib_train)
    for case in (GAT_CASES[0], GAT_CASES[2]):
        b, n, d, adj, bias, slope = case
        a32 = _gat_inputs(b, n, d, adj, bias, seed=0)
        args = {"fp32": a32, "bf16": tuple(t.to(BF16) for t in a32)}
        out[f"gat {case[:4]}"] = _bf16_row(
            f"fused_gat B={b} N={n} D={d} adj={adj}",
            lambda p: _graph_ms(lambda: fused_gat.fused_gat.forward(
                *args[p], slope)),
            _graph_ms(lambda: fused_gat.fused_gat_plain(*args["bf16"],
                                                        slope)),
            _gat_bound_ms(b, n, d, adj, elt=2), None)
    return out


def _bf16_row(what: str, kernel_ms, plain_ms: float, bound, library):
    """Times the kernel at fp32 and bf16 in turns and prints the row."""
    turns = {"fp32": [], "bf16": []}
    for precision in ("fp32", "bf16", "bf16", "fp32"):
        turns[precision].append(kernel_ms(precision))
    ms = {k: statistics.median(v) for k, v in turns.items()}
    print(f"times bf16 [{SMI}]: {what}: bf16 kernel {turns['bf16']} ms, "
          f"fp32 kernel {turns['fp32']} ms (in turns; bf16/fp32 "
          f"{ms['bf16'] / ms['fp32']:.3f}), plain bf16 {plain_ms:.6f} ms, "
          f"bound at 2-byte operands {bound[0]:.6f} ms ({bound[1]}), "
          + (f"bf16 nn.LSTM {library:.6f} ms (PyTorch's CUDA RNN: cuDNN "
             f"takes no bf16)" if library is not None else "library none"))
    return (ms["bf16"], plain_ms, *bound, library, ms["fp32"])


def _bf16(data: dict, tmp: str) -> dict:
    """Phase "bf16": the kernels' bf16 instantiations against their plain
    versions and their fp32 kernels, bf16 training (steps against the
    CPU, one FD001 epoch through the CLI), bf16 serving and a bf16
    artifact, and the times. Returns what the kernels line reports."""
    errs = _bf16_vs_plain()
    _cudnn_bf16_lstm()
    steps = {m: _bf16_steps(m) for m in BF16_TRAINED}
    epochs = {m: _bf16_epoch(m, data[CELL[m][0]]) for m in BF16_TRAINED}
    served = {m: _bf16_serve(m) for m in BF16_SERVED}
    artifact = _bf16_artifact(tmp)
    with _Clocks():
        times = _bf16_kernel_times()
    ratios = {m: _bf16_train_times(m, data[CELL[m][0]])
              for m in BF16_TRAINED}
    print(json.dumps({"bf16_train": ratios}))
    return {"errs": errs, "steps": steps, "epochs": epochs,
            "served": served, "artifact": artifact, "times": times,
            "ratios": ratios}


# Phase "resume": a run interrupted after epoch 2 and resumed from its
# --checkpoint_every 1 checkpoint against the straight 3-epoch run, dropout
# on (FC_STGNN's pe_dropout 0.1; LOGO_bearing's trunk dropout 0.2 across
# its MultiStepLR's milestone 10, at 4 steps an epoch); cut data:
# RESUME_WINDOWS training windows.
RESUME_WINDOWS = {"FC_STGNN": 2000, "LOGO_bearing": 400}


def _resume_run(method: str, data: _Processed, tmp: str) -> dict:
    from gnn_rul_tpu_torch.data.loader import load_dataset, resolve_data_path
    from gnn_rul_tpu_torch.train.trainer import Trainer
    dataset, dataset_id = CELL[method]
    bundle = load_dataset(resolve_data_path(data.root, dataset, dataset_id,
                                            "Testing_bearing_1"))
    cut = RESUME_WINDOWS[method]
    bundle.train_x, bundle.train_y = (bundle.train_x[:cut],
                                      bundle.train_y[:cut])

    def trainer(save_dir, epochs, **kw):
        return Trainer(method, dataset, dataset_id, bundle, save_dir=save_dir,
                       experiment_description="resume", run_description="r",
                       num_runs=1, num_epochs_override=epochs, **kw)

    def final(save_dir):
        run = os.path.join(save_dir, "resume", "r", f"{method}_run_0")
        return torch.load(os.path.join(run, "checkpoint.pt"),
                          map_location="cpu", weights_only=True)

    torch.backends.cudnn.deterministic = True
    straight_dir = os.path.join(tmp, f"straight_{method}")
    trainer(straight_dir, 3, checkpoint_every=1).train()
    cut_dir = os.path.join(tmp, f"resumed_{method}")
    trainer(cut_dir, 2, checkpoint_every=1).train()
    trainer(cut_dir, 3, resume=True).train()
    torch.backends.cudnn.deterministic = False
    a, b = final(straight_dir), final(cut_dir)
    names = list(a["model_dict"])
    diff = max((a["model_dict"][k].double()
                - b["model_dict"][k].double()).abs().max().item()
               for k in names)
    equal = sum(torch.equal(a["model_dict"][k], b["model_dict"][k])
                for k in names)
    x = next(iter(bundle.test.values()))[0] if bundle.is_dict_test \
        else bundle.test[0]
    preds = [serving_model(method, dataset, dataset_id, c["model_dict"],
                           batch_size=SERVE_BATCH)(x) for c in (a, b)]
    pred_diff = float(np.abs(preds[0] - preds[1]).max())
    lrs = [c["optimizer"]["param_groups"][0]["lr"] for c in (a, b)]
    print(f"resume {method}: {cut} windows, 3 epochs straight against 2, a "
          f"--checkpoint_every 1 save, a new Trainer and --resume: "
          f"{equal} of {len(names)} tensors bit-equal, max |param diff| "
          f"{diff:.3e}; predictions of {len(x)} test windows max |diff| "
          f"{pred_diff:.3e}; lr after the runs {lrs}; epochs "
          f"{a['epoch']}, {b['epoch']}; scheduler "
          f"{a['scheduler'] and a['scheduler']['last_epoch']}")
    if diff > PARAM_MAX_DIFF or pred_diff > SERVE_ATOL or lrs[0] != lrs[1] \
            or a["scheduler"] != b["scheduler"]:
        raise AssertionError(f"resume {method}: the resumed run misses")
    return {"equal": equal, "of": len(names), "diff": diff,
            "pred_diff": pred_diff}


def _save_block_ms(method: str, data: _Processed, tmp: str) -> dict:
    """How long one AsyncCheckpointer.save blocks the training thread, and
    that the step right after it does not reach the file: the saved
    weights are those before the step."""
    from gnn_rul_tpu_torch.train.checkpoint import AsyncCheckpointer
    dataset, dataset_id = CELL[method]
    torch.manual_seed(0)
    engine = Engine(build_model(method, dataset, dataset_id),
                    get_algorithm_spec(method),
                    train_params(dataset, dataset_id, method))
    xb = torch.from_numpy(data.train_x[:SERVE_BATCH]).cuda()
    yb = torch.from_numpy(data.train_y[:SERVE_BATCH]).cuda()
    engine.train_step(xb, yb)
    ckptr = AsyncCheckpointer()
    path = os.path.join(tmp, f"save_{method}.pt")
    times = []
    for rep in range(6):
        before = {k: v.detach().cpu().clone()
                  for k, v in engine.model.state_dict().items()}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ckptr.save(path, engine.model, engine.optimizer, epoch=rep, run_id=0,
                   hparams={}, train_params={}, scheduler=engine.scheduler)
        times.append((time.perf_counter() - t0) * 1e3)
        engine.train_step(xb, yb)   # rewrites the weights in place
        ckptr.wait()
        saved = torch.load(path, map_location="cpu",
                           weights_only=True)["model_dict"]
        if any(not torch.equal(saved[k], v) for k, v in before.items()):
            raise AssertionError(f"save {method}: the step after the save "
                                 f"reached the file")
    ckptr.close()
    size = os.path.getsize(path)
    print(f"resume save {method} [{SMI}]: AsyncCheckpointer.save blocks the "
          f"training thread {times[1:]} ms (after a first {times[0]:.3f}), "
          f"a checkpoint of {size} bytes; each file holds the weights of "
          f"before the step that followed its save")
    return {"block_ms": statistics.median(times[1:]), "bytes": size}


def _resume(data: dict, tmp: str) -> dict:
    """Phase "resume"."""
    out = {m: _resume_run(m, data[CELL[m][0]], tmp) for m in RESUME_WINDOWS}
    for m in RESUME_WINDOWS:
        out[m].update(_save_block_ms(m, data[CELL[m][0]], tmp))
    return out


# Phase 13, "mesh": training across the ranks of a torch.distributed job.
# The job is two ranks on the one card, over gloo by the backend rule (NCCL
# takes one rank a device): it proves the data axis and the node-sharded
# engines on the card, not their speed. MESH_WINDOWS training windows of
# FD001 (cut data), 2 epochs a run.
MESH_WINDOWS = 2000
MESH_METHODS = ("FC_STGNN", "LOGO")
MESH_RANKS = 2
MESH_TIMEOUT = 420
# Tensor parallelism on the shared card: HAGCN/FD001 at the bank's widths
# over data=1, model=2 (its second Bi-LSTM's four weights split), on FD001's
# first MESH_TP_WINDOWS training windows: 3 steps an epoch at batch 100.
MESH_TP_METHOD, MESH_TP, MESH_TP_WINDOWS = "HAGCN", "data=1,model=2", 300
# Predictions of the same weights evaluated over the data axis against one
# process (tests/test_torch_mesh_training.py's PRED_ATOL).
MESH_PRED_ATOL = 1e-4


def _mesh_args(method: str, root: str, save_dir: str, epochs: int):
    return ["--GNN_method", method, "--dataset", "CMAPSS", "--dataset_id",
            "FD001", "--data_path", root, "--save_dir", save_dir,
            "--epochs", str(epochs), "--num_runs", "1",
            "--checkpoint_every", "1"]


def _mesh_eval(method: str, root: str, save_dir: str, ckpt: str,
               mesh: Optional[str]) -> list:
    """``cli.main --eval_torch_checkpoint`` of ``ckpt`` on the test set
    (over ``--mesh <mesh>`` where given); the metrics it returns."""
    argv = _mesh_args(method, root, save_dir, 2) + [
        "--eval_torch_checkpoint", ckpt]
    return list(map(float, cli.main(argv + (["--mesh", mesh] if mesh
                                            else []))[None]))


def _mesh_data(data: _Processed, tmp: str, windows: int = MESH_WINDOWS,
               name: str = "mesh") -> str:
    """FD001's first ``windows`` training windows and its test set, as
    the preprocessor writes them, under ``<tmp>/<name>``; returns the data
    root."""
    from gnn_rul_tpu_torch.data.loader import load_dataset, resolve_data_path
    bundle = load_dataset(resolve_data_path(data.root, "CMAPSS", "FD001",
                                            None))
    root = os.path.join(tmp, name, "Processed_dataset")
    out = os.path.join(root, "CMAPSS", "FD001")
    (tx, ty), cut = bundle.test, slice(0, windows)
    save_processed(out, "train", bundle.train_x[cut].transpose(0, 2, 1),
                   bundle.train_y[cut], bundle.max_ruls)
    save_processed(out, "test", tx.transpose(0, 2, 1), ty, bundle.max_ruls)
    return root


def _mesh_launches() -> dict:
    """Each wrapper's (forward, backward) launches since :func:`_reset`,
    the keyed dropout's forward and backward alike."""
    out = {type(k).__name__: _counts(k) for k in WRAPPERS.values()}
    out["KeyedDropout"] = (keyed_dropout.keyed_dropout.launches, 0)
    return out


def _mesh_hold(what: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """``got`` against ``want`` at the kernels' tolerance; the error."""
    err = (got - want).abs()
    if not bool((err <= TOL_ATOL + TOL_RTOL * want.abs()).all()) \
            or not torch.isfinite(got).all():
        raise AssertionError(f"{what}: off by {err.max().item():.3e}")
    return err.max().item()


def _mesh_engine_cases():
    """The four node-sharded engines at the full-width shapes of their
    methods' hooks at a batch of 100: ``A @ X`` at HierCorrPool's, the
    attention panel at STFA's, the dot-graph chain (and its ring) at
    FC_STGNN's with its decay mask. ``(name, engine, inputs)``, seeded on
    the CPU and moved to the card."""
    rng = np.random.default_rng(13)

    def arr(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    hcp = build_model("HierCorrPool", "CMAPSS", "FD001")
    n_hcp = model_hparams("CMAPSS", "FD001", "HierCorrPool")["num_nodes"]
    d_hcp = hcp.gc1.Graph_Clustering.dimension_mapping.in_features
    bt = SERVE_BATCH * _STFA_HP["num_patch"]
    n_fc, d_fc, f_fc = FC_STGNN_NDF
    mask = decay_mask(_FC_HP["num_node"], 2, 0.7)
    cases = [
        ("spmm HierCorrPool", "spmm",
         {"adj": torch.softmax(arr(SERVE_BATCH, n_hcp, n_hcp), -1),
          "x": arr(SERVE_BATCH, n_hcp, d_hcp)}),
        ("gat STFA", "gat",
         {"wh": arr(bt, 14, _STFA_HP["output_dim"]), "f1": arr(bt, 14),
          "f2": arr(bt, 14), "adj": prior_knowledge_graph()}),
        ("dot graph FC_STGNN", "dot_graph",
         {"x": arr(SERVE_BATCH, n_fc, d_fc), "v": arr(SERVE_BATCH, n_fc, f_fc),
          "mask": mask}),
        ("ring FC_STGNN", "ring",
         {"x": arr(SERVE_BATCH, n_fc, d_fc), "v": arr(SERVE_BATCH, n_fc, f_fc),
          "mask": mask}),
    ]
    for _, _, t in cases:
        out_shape = (t.get("wh", t.get("x")).shape[:-1]
                     + (t.get("wh", t.get("v", t.get("x"))).shape[-1],))
        t["cot"] = arr(*out_shape)
    return [(name, engine, {k: v.cuda() for k, v in t.items()})
            for name, engine, t in cases]


def _mesh_engine(engine: str, t: dict, mesh=None):
    """The engine over ``mesh``'s model axis, or (None) the local
    computation, on the inputs ``t``."""
    from gnn_rul_tpu_torch.parallel import graph_partition as gp
    if engine == "spmm":
        return (gp.node_sharded_spmm(t["adj"], t["x"], mesh) if mesh
                else torch.einsum("bnm,bmd->bnd", t["adj"], t["x"]))
    if engine == "gat":
        slope, bias = 0.1, 0.3
        if mesh:
            return gp.node_sharded_gat(t["wh"], t["f1"], t["f2"], t["adj"],
                                       bias, slope, mesh)
        e = torch.nn.functional.leaky_relu(
            t["f1"][:, :, None] + t["f2"][:, None, :] + bias, slope)
        return torch.einsum("bnm,bmd->bnd", torch.softmax(e, -1) * t["adj"],
                            t["wh"])
    if mesh:
        fn = (gp.node_sharded_dot_graph_spmm if engine == "dot_graph"
              else gp.ring_dot_graph_spmm)
        return fn(t["x"], t["v"], mesh, mask=t["mask"])
    return fused_gnn.fused_dot_graph_spmm_plain(t["x"], t["v"], t["mask"])


def _mesh_engines(mesh) -> dict:
    """Each engine's output and its inputs' gradients (of ``sum(out *
    cot)``) over the model axis, against the local computation on the card:
    the largest error, held at the kernels' tolerance."""
    errs = {}
    for name, engine, t in _mesh_engine_cases():
        results = []
        for where in (mesh, None):
            leaves = {k: v.clone().requires_grad_(k not in ("mask", "cot",
                                                            "adj"))
                      for k, v in t.items()}
            out = _mesh_engine(engine, leaves, where)
            (out * leaves["cot"]).sum().backward()
            results.append([out.detach()] + [leaves[k].grad for k in
                                             sorted(leaves)
                                             if leaves[k].grad is not None])
        errs[name] = max(_mesh_hold(f"mesh {name}", got, want)
                         for got, want in zip(*results))
    return errs


def _mesh_hooked_step(mesh, root: str) -> float:
    """One FC_STGNN training step at a batch of 100 through the hook on
    ``mesh`` (model=2) against the step without it, from the same weights
    on the same rows: the loss and every gradient at the kernels'
    tolerance; returns the largest gradient error."""
    from gnn_rul_tpu_torch.data.loader import load_dataset, resolve_data_path
    from gnn_rul_tpu_torch.parallel.graph_partition import spmm_hook_kwargs
    bundle = load_dataset(resolve_data_path(root, "CMAPSS", "FD001", None))
    x = torch.from_numpy(bundle.train_x[:SERVE_BATCH]).cuda()
    y = torch.from_numpy(bundle.train_y[:SERVE_BATCH]).cuda()
    grads, losses = [], []
    for hook in (spmm_hook_kwargs("FC_STGNN", mesh), {}):
        torch.manual_seed(0)
        model = fc_stgnn.FCSTGNN(**_FC_HP, **hook)
        engine = Engine(model, get_algorithm_spec("FC_STGNN"),
                        train_params("CMAPSS", "FD001", "FC_STGNN"),
                        mesh=mesh if hook else None)
        losses.append(engine.train_step(x, y, key=step_key(0, 1, 0)))
        grads.append({k: p.grad for k, p in model.named_parameters()})
    _mesh_hold("mesh hooked step loss", losses[0], losses[1])
    return max(_mesh_hold(f"mesh hooked step {k}", grads[0][k], g)
               for k, g in grads[1].items())


def _packed(mask: torch.Tensor) -> tuple:
    return tuple(mask.shape), np.packbits(mask.numpy().reshape(-1))


def _unpacked(shape: tuple, bits: np.ndarray) -> torch.Tensor:
    n = int(np.prod(shape))
    return torch.from_numpy(np.unpackbits(bits)[:n].astype(bool)).reshape(
        shape)


@contextlib.contextmanager
def _recording_steps(record: list, sel, rank: int, meta=None):
    """Inside the block, each training step of an Engine appends ``(state,
    gradients, loss, masks)`` to ``record``: on rank 0 the model's state
    before the step, its gradients summed over the ranks and the global
    loss (else None), and the (leaky) ReLU masks that ``sel`` (a SIGNED
    recorder, or None) took in the step's forward, packed, on this rank's
    rows; other choices (top-k's indices) as recorded. A model
    split over the model axis is recorded whole: its state and gradients
    gathered from the model ranks (collectives every rank joins);
    ``meta["bytes"]`` the bytes this rank holds of each split parameter and
    its Adam moments after the first step, and ``meta["replicated"]`` the
    digest of this rank's replicated parameters and buffers after each step
    (:func:`_replicated_digest`)."""
    from gnn_rul_tpu_torch.parallel.model_axis import (local_bytes,
                                                       placement_of,
                                                       whole_grads)
    step = Engine.train_step

    def recording(self, x, y, key=None):
        placement = placement_of(self.model)
        sd = (self.model.state_dict() if placement is None
              else placement.whole_state_dict(self.model))
        state = ({k: v.detach().cpu().clone() for k, v in sd.items()}
                 if rank == 0 else None)
        start = len(sel.card) if sel else 0
        with _during(sel, "record"):
            loss = step(self, x, y, key)
        grads = whole_grads(self.model)
        grads = ({k: g.cpu() for k, g in grads.items()} if rank == 0
                 else None)
        total = loss.clone()
        if self.data_group is not None:
            torch.distributed.all_reduce(total, group=self.data_group)
        masks = [(name, *_packed(chosen)) if chosen.dtype == torch.bool
                 else (name, sig, chosen, x)
                 for name, sig, chosen, x in (sel.card[start:] if sel
                                              else [])]
        record.append((state, grads, float(total), masks))
        if meta is not None:
            meta.setdefault("bytes", local_bytes(self.model, self.optimizer))
            meta.setdefault("replicated", []).append(
                _replicated_digest(self.model))
        return loss

    Engine.train_step = recording
    try:
        yield
    finally:
        Engine.train_step = step


def _replicated_digest(model) -> str:
    """SHA-256 of the bytes of ``model``'s parameters and buffers that are
    not split over the model axis, in ``state_dict`` order: equal on two
    model ranks only where their copies are the same bits."""
    import hashlib
    from gnn_rul_tpu_torch.parallel.model_axis import placement_of
    placement = placement_of(model)
    split = placement.axes if placement is not None else {}
    h = hashlib.sha256()
    for k, v in model.state_dict().items():
        if k not in split:
            h.update(k.encode())
            h.update(v.detach().cpu().reshape(-1).contiguous()
                     .view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def _mesh_run(method: str) -> str:
    """A run's directory under its save_dir."""
    return os.path.join("GNN_RUL", "run_1", f"{method}_run_0")


def _tp_step_ms(root: str, mesh=None) -> float:
    """The median ms of a HAGCN (MESH_TP_METHOD) training step at batch
    100 on FD001's first rows (:func:`_step_ms`), its engine over ``mesh``
    (every rank of it times its own) or in this process."""
    from gnn_rul_tpu_torch.data.loader import load_dataset, resolve_data_path
    bundle = load_dataset(resolve_data_path(root, "CMAPSS", "FD001", None))
    x = torch.from_numpy(bundle.train_x[:SERVE_BATCH]).cuda()
    y = torch.from_numpy(bundle.train_y[:SERVE_BATCH]).cuda()
    torch.manual_seed(0)
    method = MESH_TP_METHOD
    engine = Engine(build_model(method, "CMAPSS", "FD001"),
                    get_algorithm_spec(method),
                    train_params("CMAPSS", "FD001", method), mesh=mesh)
    return _step_ms(engine, x, y)


def _mesh_tp_rank(out: str, root: str, rank: int) -> dict:
    """HAGCN (MESH_TP_METHOD) on ``--mesh data=1,model=2`` through
    ``cli.main``: 2 epochs, the launches counted from 0 before them, rank 0
    recording every step's whole weights and whole gradient and each rank
    its top-k selections (``<out>/steps_tp_<rank>.pt``); rank 0's final
    checkpoint evaluated over the same mesh, each rank's selections
    recorded (``<out>/eval_tp_<rank>.pt``); 1 epoch and a resume to 2; a
    training step's median ms over the mesh (:func:`_tp_step_ms`). Returns
    this rank's wall s, launches, bytes of its split parameters and their
    Adam moments, the digests of its replicated state after each step,
    metrics and step ms."""
    import torch.distributed as dist
    from gnn_rul_tpu_torch.parallel.mesh import make_mesh
    method = MESH_TP_METHOD
    mesh = make_mesh(1, MESH_RANKS, device="cuda")
    mine = os.path.join(out, f"rank{rank}")
    record, meta = [], {}
    _reset()
    t0 = time.perf_counter()
    with _recording_steps(record, _replayer(method), rank, meta):
        cli.main(_mesh_args(method, root, mine, 2) + ["--mesh", MESH_TP])
    torch.cuda.synchronize()
    res = {"s": time.perf_counter() - t0, "launches": _mesh_launches(),
           "bytes": meta["bytes"], "replicated": meta["replicated"]}
    torch.save(record, os.path.join(out, f"steps_tp_{rank}.pt"))
    dist.barrier()  # rank 0's final checkpoint is on disk
    sel = _replayer(method)
    with _during(sel, "record"):
        res["eval"] = _mesh_eval(method, root, mine, os.path.join(
            out, "rank0", _mesh_run(method), "checkpoint.pt"), MESH_TP)
    torch.save(sel.card, os.path.join(out, f"eval_tp_{rank}.pt"))
    resumed = os.path.join(out, f"resumed{rank}")
    cli.main(_mesh_args(method, root, resumed, 1) + ["--mesh", MESH_TP])
    cli.main(_mesh_args(method, root, resumed, 2)
             + ["--mesh", MESH_TP, "--resume"])
    res["step_ms"] = _tp_step_ms(root, mesh)
    return res


def _mesh_rank(out: str, root: str, tp_root: str) -> None:
    """One rank of phase 13's job (``GNNRUL_*`` set by
    ``_dist_worker.launch``): ``cli.main --mesh data=2`` trains FC_STGNN
    (with ``--profile``) and LOGO for 2 epochs, each rank writing under its
    own save_dir, the launches counted from 0 before each, and rank 0
    recording every step's weights and summed gradients
    and both ranks their (leaky) ReLU masks (:func:`_recording_steps`,
    ``<out>/steps_<method>_<rank>.pt``); each rank then evaluates rank 0's
    final checkpoint over the data axis (``--eval_torch_checkpoint``, rank
    0 writing the predictions); FC_STGNN again
    for 1 epoch and resumed to 2; then, on ``data=1, model=2``, the four
    engines, a training step through FC_STGNN's hook and HAGCN's runs
    split over the model axis (:func:`_mesh_tp_rank`, on ``tp_root``).
    Writes ``<out>/rank<r>.json``."""
    import torch.distributed as dist
    from gnn_rul_tpu_torch.parallel.mesh import make_mesh
    from gnn_rul_tpu_torch.parallel.multihost import initialize_from_env
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # The resumed run to land on the straight one bit for bit, as phase 12.
    torch.backends.cudnn.deterministic = True
    if not initialize_from_env("cuda"):
        raise RuntimeError("phase 13's rank found no GNNRUL_* job")
    rank = dist.get_rank()
    mine = os.path.join(out, f"rank{rank}")
    res = {"rank": rank, "backend": dist.get_backend(), "runs": {}}
    for method in MESH_METHODS:
        argv = _mesh_args(method, root, mine, 2) + ["--mesh", "data=2"]
        if method == "FC_STGNN":
            argv += ["--profile", os.path.join(out, "trace")]
        record = []
        _reset()
        t0 = time.perf_counter()
        with _recording_steps(record, _signs(method) if method in SIGNED
                              else None, rank):
            cli.main(argv)
        torch.cuda.synchronize()
        res["runs"][method] = {"s": time.perf_counter() - t0,
                               "launches": _mesh_launches()}
        torch.save(record, os.path.join(out, f"steps_{method}_{rank}.pt"))
        dist.barrier()  # rank 0's final checkpoint is on disk
        res["runs"][method]["eval"] = _mesh_eval(
            method, root, mine, os.path.join(out, "rank0", _mesh_run(method),
                                             "checkpoint.pt"), "data=2")
    resumed = os.path.join(out, f"resumed{rank}")
    cli.main(_mesh_args("FC_STGNN", root, resumed, 1) + ["--mesh", "data=2"])
    cli.main(_mesh_args("FC_STGNN", root, resumed, 2)
             + ["--mesh", "data=2", "--resume"])
    model_mesh = make_mesh(1, MESH_RANKS, device="cuda")
    res["engines"] = _mesh_engines(model_mesh)
    res["hooked_step"] = _mesh_hooked_step(model_mesh, root)
    res["tp"] = _mesh_tp_rank(out, tp_root, rank)
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(res, f)
    dist.destroy_process_group()


def _mesh_gradients(method: str, root: str, out: str) -> tuple:
    """Every step of the job's ``method`` run held as GRADIENT_HELD holds
    phase 6's: one process's loss and gradient at the job's weights before
    the step, on the step's global batch (the permutation of
    ``Engine.run_epoch``, seeded by ``(seed, epoch)``) under the step's
    dropout key, against the job's global loss (at the 5-step tolerance)
    and summed gradient (at the kernels'). For a SIGNED method
    the one process replays the job's (leaky) ReLU masks, the ranks' blocks
    joined in row order (the data axis computes BatchNorm's statistics in
    another order, so an input within rounding of 0 can take the other
    side, as between phase 10's vectorized and sequential runs). Returns
    the steps, the largest error and the masks that differ."""
    from gnn_rul_tpu_torch.data.loader import load_dataset, resolve_data_path
    record, other = (torch.load(os.path.join(out, f"steps_{method}_{r}.pt"),
                                weights_only=False) for r in (0, 1))
    bundle = load_dataset(resolve_data_path(root, "CMAPSS", "FD001", None))
    x_all = torch.from_numpy(bundle.train_x).cuda()
    y_all = torch.from_numpy(bundle.train_y).cuda()
    n, bs = len(x_all), SERVE_BATCH
    per_epoch = -(-n // bs)
    engine = Engine(build_model(method, "CMAPSS", "FD001"),
                    get_algorithm_spec(method),
                    train_params("CMAPSS", "FD001", method))
    err, flips = 0.0, 0
    for k, ((state, grads, loss, masks), (_, _, _, masks1)) in enumerate(
            zip(record, other)):
        epoch, i = k // per_epoch + 1, k % per_epoch
        sel = None
        if masks:
            sel = _signs(method)
            sel.card = []
            for (name, shape, bits), (_, shape1, bits1) in zip(masks, masks1):
                mask = torch.cat([_unpacked(shape, bits),
                                  _unpacked(shape1, bits1)])
                sel.card.append((name, (mask.shape,), mask, None))
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0 * 1_000_003 + epoch)
        idx = torch.randperm(n, generator=gen, device="cuda")[i * bs:
                                                             (i + 1) * bs]
        engine.model.load_state_dict(state)
        with _during(sel, "replay"):
            want = engine.train_step(x_all[idx], y_all[idx],
                                     key=step_key(0, epoch, i))
        np.testing.assert_allclose(loss, float(want), rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL)
        if sel:
            flips += sel.report(method, f"step {k} of the 2-rank job")
        for name, p in engine.model.named_parameters():
            err = max(err, _mesh_hold(f"mesh {method} step {k} {name}",
                                      grads[name].cuda(), p.grad))
    if len(record) != 2 * per_epoch:
        raise AssertionError(f"mesh {method}: {len(record)} steps recorded")
    return len(record), err, flips


def _mesh_tp_gradients(root: str, out: str) -> tuple:
    """Every step of the job's HAGCN run on ``data=1, model=2`` held as
    GRADIENT_HELD holds phase 6's: one process's loss and gradient at the
    job's whole weights before the step, on the step's batch under its
    dropout key, replaying the job's top-k selections (ROADMAP Queue 3
    entry 6), against the job's loss (at the 5-step tolerance) and whole
    gradient (at the kernels'); each step's selections on rank 1 are rank
    0's, index for index. Returns the steps, the largest error and the
    selections that differ between card and CPU."""
    from gnn_rul_tpu_torch.data.loader import load_dataset, resolve_data_path
    method = MESH_TP_METHOD
    records = [torch.load(os.path.join(out, f"steps_tp_{r}.pt"),
                          weights_only=False) for r in range(MESH_RANKS)]
    _same_choices("steps", [[e for *_, masks in rec for e in masks]
                            for rec in records])
    record = records[0]
    bundle = load_dataset(resolve_data_path(root, "CMAPSS", "FD001", None))
    x_all = torch.from_numpy(bundle.train_x).cuda()
    y_all = torch.from_numpy(bundle.train_y).cuda()
    n, bs = len(x_all), SERVE_BATCH
    per_epoch = -(-n // bs)
    engine = Engine(build_model(method, "CMAPSS", "FD001"),
                    get_algorithm_spec(method),
                    train_params("CMAPSS", "FD001", method))
    err, differ = 0.0, 0
    for k, (state, grads, loss, chosen) in enumerate(record):
        epoch, i = k // per_epoch + 1, k % per_epoch
        sel = _replayer(method)
        sel.card = chosen
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0 * 1_000_003 + epoch)
        idx = torch.randperm(n, generator=gen, device="cuda")[i * bs:
                                                             (i + 1) * bs]
        engine.model.load_state_dict(state)
        with _during(sel, "replay"):
            want = engine.train_step(x_all[idx], y_all[idx],
                                     key=step_key(0, epoch, i))
        np.testing.assert_allclose(loss, float(want), rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL)
        differ += sel.report(method, f"step {k} of the model=2 job")
        for name, p in engine.model.named_parameters():
            err = max(err, _mesh_hold(f"mesh {method} model=2 step {k} "
                                      f"{name}", grads[name].cuda(), p.grad))
    if len(record) != 2 * per_epoch:
        raise AssertionError(f"mesh {method} model=2: {len(record)} steps "
                             f"recorded")
    return len(record), err, differ


def _same_choices(what: str, cards: list) -> None:
    """Fails unless every rank's top-k selections (``cards``, a list of
    ``_Replay`` card entries a rank) are rank 0's, index for index: each
    model rank computes the whole forward from the same weights and
    rows."""
    for r, card in enumerate(cards[1:], 1):
        if len(card) != len(cards[0]) or any(
                (a[0], a[1]) != (b[0], b[1]) or not torch.equal(a[2], b[2])
                for a, b in zip(cards[0], card)):
            raise AssertionError(f"mesh {MESH_TP_METHOD} model=2 {what}: "
                                 f"rank {r}'s top-k selections are not rank "
                                 f"0's")


def _mesh_tp(root: str, out: str, single: str, ranks: list,
             want_launches: dict) -> dict:
    """HAGCN's runs on ``data=1, model=2`` (:func:`_mesh_tp_rank`) held
    against one process (``single``'s runs, ``want_launches`` their
    launches): each rank's launches equal one process's; each rank holds
    half of each of the four split Bi-LSTM weights and of their Adam
    moments; after every step the ranks' replicated parameters and buffers
    the same bits; every step's loss and whole gradient, and the ranks'
    top-k selections the same (:func:`_mesh_tp_gradients`);
    rank 0's checkpoint whole (the unsplit model's shapes, Adam's too), its
    predictions over the model axis against one process's on the same
    weights, the job's selections replayed, within MESH_PRED_ATOL; the
    resumed run against the straight one; a step's median ms on each rank
    and in one process."""
    method = MESH_TP_METHOD
    lstm = type(fused_lstm.lstm_recurrence).__name__
    for r in ranks:
        got = {k: tuple(v) for k, v in r["tp"]["launches"].items()}
        if got != want_launches:
            raise AssertionError(f"mesh {method} model=2 rank {r['rank']} "
                                 f"launched {got}, one process "
                                 f"{want_launches}")
    if want_launches[lstm] == (0, 0):
        raise AssertionError(f"mesh {method} model=2: no recurrence kernel")
    model = build_model(method, "CMAPSS", "FD001")
    split = sorted(f"TD.bi_lstm2.weight_{w}_l0{sfx}" for w in ("ih", "hh")
                   for sfx in ("", "_reverse"))
    params = dict(model.named_parameters())
    whole = {k: 3 * params[k].numel() * params[k].element_size()
             for k in split}
    for r in ranks:
        if sorted(r["tp"]["bytes"]) != split or any(
                2 * r["tp"]["bytes"][k] != whole[k] for k in split):
            raise AssertionError(f"mesh {method} model=2 rank {r['rank']} "
                                 f"holds {r['tp']['bytes']}, whole {whole}")
    steps, grad_err, differ = _mesh_tp_gradients(root, out)
    digests = [r["tp"]["replicated"] for r in ranks]
    if len(digests[0]) != steps or any(d != digests[0] for d in digests):
        raise AssertionError(f"mesh {method} model=2: the ranks' replicated "
                             f"parameters and buffers part: {digests}")
    run = _mesh_run(method)
    ckpt = os.path.join(out, "rank0", run, "checkpoint.pt")
    payload = torch.load(ckpt, map_location="cpu", weights_only=True)
    shapes = {k: tuple(v.shape) for k, v in payload["model_dict"].items()}
    if shapes != {k: tuple(v.shape) for k, v in model.state_dict().items()}:
        raise AssertionError(f"mesh {method} model=2: rank 0's checkpoint "
                             f"is not whole: {shapes}")
    adam = payload["optimizer"]["state"]
    if any(tuple(adam[i][m].shape) != tuple(p.shape)
           for i, p in enumerate(model.parameters())
           for m in ("exp_avg", "exp_avg_sq")):
        raise AssertionError(f"mesh {method} model=2: Adam's state is not "
                             f"whole")
    cards = [torch.load(os.path.join(out, f"eval_tp_{r['rank']}.pt"),
                        weights_only=False) for r in ranks]
    _same_choices("evaluation", cards)
    sel = _replayer(method)
    sel.card = cards[0]
    with _during(sel, "replay"):
        metrics = _mesh_eval(method, root, single, ckpt, None)
    eval_differ = sel.report(method, "the model=2 evaluation")
    preds = [np.load(os.path.join(d, "GNN_RUL", "run_1", f"{method}_eval",
                                  "results.npz"))
             for d in (os.path.join(out, "rank0"), single)]
    np.testing.assert_allclose(preds[0]["pre"], preds[1]["pre"],
                               atol=MESH_PRED_ATOL, rtol=0)
    pred_err = float(np.max(np.abs(preds[0]["pre"] - preds[1]["pre"])))
    a, b = (torch.load(os.path.join(out, d, run, "checkpoint.pt"),
                       map_location="cpu", weights_only=True)["model_dict"]
            for d in ("resumed0", "rank0"))
    resume_diff = max((a[k].double() - b[k].double()).abs().max().item()
                      for k in b if b[k].is_floating_point())
    if resume_diff > PARAM_MAX_DIFF:
        raise AssertionError(f"mesh {method} model=2: the resumed run "
                             f"misses the straight one by {resume_diff}")
    step_ms = [r["tp"]["step_ms"] for r in ranks]
    single_ms = _tp_step_ms(root)
    print(f"mesh {method} model=2 [{SMI}]: cli.main --mesh {MESH_TP} as 2 "
          f"ranks on one card (gloo) against one process, 2 epochs of "
          f"{MESH_TP_WINDOWS} windows at the bank's widths; each rank holds "
          f"its half of TD.bi_lstm2's four weights (240 rows of 480) and of "
          f"their Adam moments, bytes a rank {ranks[0]['tp']['bytes']} of "
          f"{whole} whole; after each of {steps} steps the ranks' "
          f"replicated parameters and buffers the same bits, and their top-k "
          f"selections the same in every step and the evaluation; each "
          f"step's whole gradient at the "
          f"job's weights within atol={TOL_ATOL}, rtol={TOL_RTOL} of one "
          f"process's (max |err| {grad_err:.3e}; the job's top-k selections "
          f"replayed, {differ} differ) and its loss within rtol={LOSS_RTOL}; "
          f"rank 0's checkpoint whole; its weights evaluated over model=2 "
          f"against one process: {len(preds[0]['pre'])} predictions within "
          f"{MESH_PRED_ATOL} (max |err| {pred_err:.3e}; {eval_differ} "
          f"selections differ, replayed), metrics {ranks[0]['tp']['eval']} "
          f"on each rank, one process {metrics}; the resumed run against "
          f"the straight one: max |param diff| {resume_diff:.3e}; a step at "
          f"batch 100, median of 20 (ms): model=2 {step_ms} (each rank), "
          f"one process {single_ms:.3f} (gloo's cost on one card, not a "
          f"scaling figure); "
          f"launches a rank {want_launches[lstm]} ({lstm}), equal on each "
          f"rank and one process; wall s of the run a rank "
          f"{[round(r['tp']['s'], 3) for r in ranks]}")
    for r in ranks:
        np.testing.assert_allclose(r["tp"]["eval"], ranks[0]["tp"]["eval"],
                                   rtol=1e-6)
    return {"steps_held": steps, "grad_err": grad_err,
            "topk_differ": differ, "eval_pred_err": pred_err,
            "eval_topk_differ": eval_differ, "resume_param_diff": resume_diff,
            "bytes_rank": ranks[0]["tp"]["bytes"], "bytes_whole": whole,
            "step_ms_model2": step_ms, "step_ms_single": single_ms,
            "launches": want_launches[lstm],
            "rank_s": [r["tp"]["s"] for r in ranks]}


def _epoch_times(run_dir: str) -> list:
    """``(s, samples/s)`` of each epoch, read from a run's log."""
    with open(os.path.join(run_dir, "logs_run_0.log")) as f:
        return [(float(s), float(sps.replace(",", "")))
                for s, sps in re.findall(r"\((\S+)s \| (\S+) samples/s",
                                         f.read())]


def _mesh_trace_top(trace_dir: str, n: int = 10) -> tuple:
    """The ``n`` longest device operations of the trace and the ``n``
    device kernels of most total time (name, us, calls); fails where the
    trace names no dot-graph operator or holds no device operation."""
    files = [os.path.join(trace_dir, f) for f in os.listdir(trace_dir)
             if f.endswith(".pt.trace.json")]
    if len(files) != 1:
        raise AssertionError(f"--profile wrote {files}")
    with open(files[0]) as f:
        text = f.read()
    if "gnn_rul_tpu_torch::fused_dot_graph_spmm" not in text:
        raise AssertionError("the trace names no fused_dot_graph_spmm")
    events = [e for e in json.loads(text)["traceEvents"]
              if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    if not events:
        raise AssertionError("the trace holds no device operation")
    events.sort(key=lambda e: -e.get("dur", 0))
    totals: dict = {}
    for e in events:
        us, calls = totals.get(e["name"], (0.0, 0))
        totals[e["name"]] = (us + e.get("dur", 0), calls + 1)
    by_total = sorted(totals.items(), key=lambda kv: -kv[1][0])[:n]
    return ([(e["name"][:80], e["dur"]) for e in events[:n]],
            [(name[:80], round(us, 1), calls)
             for name, (us, calls) in by_total])


def _mesh(data: dict, tmp: str) -> dict:
    """Phase "mesh": the 2-rank job of :func:`_mesh_rank` on this card,
    held against the same runs in this process; ``complexity_computation``
    of FC_STGNN on the card and the CPU."""
    from gnn_rul_tpu_torch.parallel._dist_worker import launch
    from gnn_rul_tpu_torch.utils import complexity_computation
    t_phase = time.perf_counter()
    root = _mesh_data(data["CMAPSS"], tmp)
    tp_root = _mesh_data(data["CMAPSS"], tmp, MESH_TP_WINDOWS, "mesh_tp")
    single = os.path.join(tmp, "mesh", "single")
    runs = {}
    for method, where in [(m, root) for m in MESH_METHODS] + [
            (MESH_TP_METHOD, tp_root)]:
        _reset()
        t0 = time.perf_counter()
        cli.main(_mesh_args(method, where, single, 2))
        torch.cuda.synchronize()
        runs[method] = {"s": time.perf_counter() - t0,
                        "launches": _mesh_launches()}
    out = os.path.join(tmp, "mesh", "job")
    os.makedirs(out)
    t0 = time.perf_counter()
    launch(["-c", f"import chip_smoke as c; c._mesh_rank({out!r}, "
                  f"{root!r}, {tp_root!r})"], MESH_RANKS, MESH_TIMEOUT,
           log_dir=os.path.join(out, "logs"))
    job_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ranks = []
    for r in range(MESH_RANKS):
        with open(os.path.join(out, f"rank{r}.json")) as f:
            ranks.append(json.load(f))
    if any(r["backend"] != "gloo" for r in ranks):
        raise AssertionError(f"backends {[r['backend'] for r in ranks]}")
    for r in ranks[1:]:
        if os.path.exists(os.path.join(out, f"rank{r['rank']}")) \
                or os.path.exists(os.path.join(out, f"resumed{r['rank']}")):
            raise AssertionError(f"rank {r['rank']} wrote artifacts")
    result = {"ranks": MESH_RANKS, "backend": "gloo", "windows": MESH_WINDOWS,
              "job_s": job_s}
    for method in MESH_METHODS:
        want = {k: tuple(v) for k, v in runs[method]["launches"].items()}
        for r in ranks:
            got = {k: tuple(v)
                   for k, v in r["runs"][method]["launches"].items()}
            if got != want:
                raise AssertionError(f"mesh {method} rank {r['rank']} "
                                     f"launched {got}, one process {want}")
        if not any(v != (0, 0) for v in want.values()):
            raise AssertionError(f"mesh {method}: no kernel launched")
        run = _mesh_run(method)
        ckpt = os.path.join(out, "rank0", run, "checkpoint.pt")
        a = torch.load(ckpt, map_location="cpu",
                       weights_only=True)["model_dict"]
        b = torch.load(os.path.join(single, run, "checkpoint.pt"),
                       map_location="cpu", weights_only=True)["model_dict"]
        diff = max((a[k].double() - b[k].double()).abs().max().item()
                   for k in b if b[k].is_floating_point())
        rows = [np.array(_results_rows(os.path.join(d, run), None)[-1],
                         dtype=float) for d in (os.path.join(out, "rank0"),
                                                single)]
        rdiff = float(np.max(np.abs(rows[0] - rows[1]) / np.abs(rows[1])))
        # The same weights, rank 0's final ones, evaluated over the data
        # axis (each rank, LOGO's Bi-LSTM over the gathered rows) and in
        # this process: the predictions at MESH_PRED_ATOL, and every rank
        # the whole vector's metrics.
        metrics = _mesh_eval(method, root, single, ckpt, None)
        preds = [np.load(os.path.join(d, "GNN_RUL", "run_1",
                                      f"{method}_eval", "results.npz"))
                 for d in (os.path.join(out, "rank0"), single)]
        if not np.array_equal(preds[0]["real"], preds[1]["real"]):
            raise AssertionError(f"mesh {method}: eval labels differ")
        np.testing.assert_allclose(preds[0]["pre"], preds[1]["pre"],
                                   atol=MESH_PRED_ATOL, rtol=0)
        pred_err = float(np.max(np.abs(preds[0]["pre"] - preds[1]["pre"])))
        for r in ranks:
            np.testing.assert_allclose(r["runs"][method]["eval"],
                                       ranks[0]["runs"][method]["eval"],
                                       rtol=1e-6)
        steps, grad_err, flips = _mesh_gradients(method, root, out)
        epochs = [_epoch_times(os.path.join(d, run))
                  for d in (os.path.join(out, "rank0"), single)]
        print(f"mesh {method} [{SMI}]: cli.main --mesh data=2 as 2 ranks on "
              f"one card (gloo) against one process, 2 epochs of "
              f"{MESH_WINDOWS} windows: each of {steps} steps' summed "
              f"gradient at the job's weights within atol={TOL_ATOL}, "
              f"rtol={TOL_RTOL} of one process's (max |err| "
              f"{grad_err:.3e}; {flips} (leaky) ReLU masks replayed that "
              f"differ) and each step's loss within rtol={LOSS_RTOL}, "
              f"atol={LOSS_ATOL}; free-running after the 2 epochs (not held: "
              f"Adam moves a weight whose gradient is rounding noise by the "
              f"learning rate either way, and the runs part; ROADMAP Queue 3 "
              f"entry 19): max |param diff| {diff:.3e}, best row relative "
              f"diff {rdiff:.3e}; rank 0's final weights evaluated over the "
              f"data axis against one process: {len(preds[0]['pre'])} "
              f"predictions within {MESH_PRED_ATOL} (max |err| "
              f"{pred_err:.3e}), metrics {ranks[0]['runs'][method]['eval']} "
              f"on each rank, one process {metrics}; epochs (s, samples/s) on rank 0 "
              f"{epochs[0]}, one process {epochs[1]}; launches a rank "
              f"{ {k: v for k, v in want.items() if v != (0, 0)} }, equal on "
              f"each rank and one process; wall s of the run a rank "
              f"{[round(r['runs'][method]['s'], 3) for r in ranks]}, one "
              f"process {runs[method]['s']:.3f} (two ranks sharing one card: "
              f"not a scaling figure)")
        result[method] = {"steps_held": steps, "grad_err": grad_err,
                          "epochs_rank0": epochs[0], "epochs_single": epochs[1],
                          "relu_flips": flips,
                          "param_diff": diff, "row_rdiff": rdiff,
                          "eval_pred_err": pred_err,
                          "launches": {k: v for k, v in want.items()
                                       if v != (0, 0)},
                          "rank_s": [r["runs"][method]["s"] for r in ranks],
                          "single_s": runs[method]["s"]}
    result["HAGCN model=2"] = _mesh_tp(
        tp_root, out, single, ranks,
        {k: tuple(v) for k, v in runs[MESH_TP_METHOD]["launches"].items()})
    result["held_s"] = time.perf_counter() - t0
    run = _mesh_run("FC_STGNN")
    a, b = (torch.load(os.path.join(out, d, run, "checkpoint.pt"),
                       map_location="cpu", weights_only=True)["model_dict"]
            for d in ("resumed0", "rank0"))
    resume_diff = max((a[k].double() - b[k].double()).abs().max().item()
                      for k in b if b[k].is_floating_point())
    # The resumed job records nothing: its epochs are the clean 2-rank ones.
    clean = _epoch_times(os.path.join(out, "resumed0", run))
    print(f"mesh resume: FC_STGNN 1 epoch then --resume to 2 on the 2-rank "
          f"job against its straight 2 epochs: max |param diff| "
          f"{resume_diff:.3e}; its epochs (s, samples/s) {clean} [{SMI}, two "
          f"ranks sharing one card over gloo]")
    if resume_diff > PARAM_MAX_DIFF:
        raise AssertionError("mesh: the resumed job misses the straight one")
    print(f"mesh engines (model=2, 2 ranks on one card) against the local "
          f"computation on the card, outputs and gradients at atol="
          f"{TOL_ATOL}, rtol={TOL_RTOL}: max |err| "
          f"{ranks[0]['engines']}; FC_STGNN's step through the hook: max "
          f"|grad err| {ranks[0]['hooked_step']:.3e}")
    top, by_total = _mesh_trace_top(os.path.join(out, "trace"))
    print(f"mesh profile [{SMI}]: --profile of FC_STGNN's epoch 2 on rank 0 "
          f"of the 2-rank job names fused_dot_graph_spmm; its ten longest "
          f"device operations (us): {top}; the ten kernels of most total "
          f"time (us, calls): {by_total}")
    model = build_model("FC_STGNN", "CMAPSS", "FD001")
    counts = [complexity_computation(model.to(dev), 14, 50)
              for dev in ("cuda", "cpu")]
    print(f"mesh complexity_computation FC_STGNN (1, 14, 50): card "
          f"{counts[0]}, CPU {counts[1]} (flops, params)")
    if counts[0] != counts[1] or counts[0][0] <= 0:
        raise AssertionError("complexity_computation differs card to CPU")
    result.update(resume_param_diff=resume_diff, resume_epochs=clean,
                  trace_by_total=by_total, engines=ranks[0]["engines"],
                  hooked_step_grad_err=ranks[0]["hooked_step"],
                  trace_top=top, flops=counts[0][0], params=counts[0][1],
                  phase_s=time.perf_counter() - t_phase)
    return result


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
    drop_err = _dropout_vs_plain()
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
        _preprocess(tmp)
        phases.mark("preprocess")
        data = {"CMAPSS": _write_fd001(tmp), "PHM2012": _write_phm2012(tmp)}
        trained = {m: _train_entry_point(m, data[CELL[m][0]])
                   for m in METHODS}
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
            # LOGO's, HAGCN's and LOGO_bearing's shapes, at PHM2012 and at
            # XJTU-SY (B = 544, ROADMAP Queue 2's debt); (100, 70, 24),
            # (1000, 70, 48) and LOGO_bearing's H = 60 layer are cut (a
            # timing depth, PERF.md §4).
            lstm = _lstm_times([(100, 70, 48), (1400, 5, 60),
                                (1400, 5, 120), (14000, 5, 120),
                                (100, 200, 30), (100, 544, 30)])
            _lstm_cluster_times()
            # Kernel #4's step by phase at HAGCN's shapes, on each step
            # design (chip_smoke's stamped build of csrc/fused_lstm.cu).
            for step in range(len(fused_lstm.STEPS)):
                _lstm_stamps(step=step)
            phases.mark("kernel times, LSTM")
            # The serving and training shapes of STAGNN and STFA, the two
            # check shapes of few large graphs, GAT_LSTM's and GDAGDL's
            # first layers at batch 100.
            gat = _gat_times([GAT_CASES[k] for k in (0, 1, 2, 3, 4, 7, 10,
                                                     11)])
        phases.mark("kernel times, attention")
        with _Clocks():
            drop_times = _dropout_times()
        _dropout_step_times()
        phases.mark("kernel times, dropout")
        for method in METHODS:
            _serve_times(method, *served[method][:4])
            _artifact_times(method, artifacts[method][0],
                            *served[method][1:3])
            _train_times(method, data[CELL[method][0]])
            phases.mark(f"times {method}")
        for tier, models in tiers.items():
            _serve_times(tier, *models[:4])
        phases.mark("times, tiers")
        grouped_err = _grouped_vs_plain()
        grouped = _grouped_times()
        vectorized = {m: _vectorized(m) for m in VECTORIZED_METHODS}
        vec_times = {m: _vectorized_times(m, data[CELL[m][0]])
                     for m in VECTORIZED_METHODS}
        phases.mark("vectorized")
        bf16 = _bf16(data, tmp)
        phases.mark("bf16")
        resumed = _resume(data, tmp)
        phases.mark("resume")
        mesh = _mesh(data, tmp)
        phases.mark("mesh")
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

    def launches_of(method, backward=False):
        """``method``'s launches on each of its main paths: serving, the
        artifacts, its epoch and ``--eval_torch_checkpoint`` (the
        backward's: its epoch only)."""
        key = method.lower()
        if backward:
            return {f"launches_{key}_epoch": trained[method][1]}
        return {f"launches_{key}_serve": served[method][4],
                f"launches_{key}_artifact": artifacts[method][1],
                f"launches_{key}_epoch": trained[method][0],
                f"launches_{key}_eval": trained[method][3]}

    def logo_bearing(part):
        """LOGO_bearing's launches and the kernel's times at its trunk's
        first (T, B, H), at PHM2012 (B = 200) and XJTU-SY (B = 544)."""
        out = launches_of("LOGO_bearing", part == "bwd")
        for b, prefix in ((200, "logo_bearing_h30"),
                          (544, "logo_bearing_xjtu_b544")):
            out.update(at(lstm[(100, b, 30)][part], prefix),
                       **{f"{prefix}_library_ms": lstm[(100, b, 30)][part][4]})
        return out

    def seeds(methods, part, key, times):
        """The vectorized phase's launches of ``methods`` (``part`` 0
        forward, 1 backward) and the grouped kernel's times at ``key``."""
        out = {"grouped_max_abs_err": grouped_err[times],
               **at(grouped[key], "grouped_g5")}
        for m in methods:
            out[f"launches_vectorized_{m.lower()}_steps"] = \
                vectorized[m]["steps"][part]
            if part == 0:
                out[f"launches_vectorized_{m.lower()}_eval"] = \
                    vectorized[m]["eval"]
        return out

    lstm_shape = (100, 70, 48)
    tier5 = tiers["LOGO_bearing XJTU_SY/Condition_1"][4]
    logo5 = f"lstm {GROUPED_LSTM[0][0]}x{GROUPED_LSTM[0][1]}x" \
            f"{GROUPED_LSTM[0][2]}"
    lstm_methods = ("LOGO", "HAGCN", "LOGO_bearing")
    def bf16_entry(name, key, err, launches, source, replaces, **extra):
        ms, plain_ms, bound_ms, bound_by, library, fp32_ms = \
            bf16["times"][key]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bound_ms, "bound_by": bound_by,
                "library_ms": library, "fp32_ms": fp32_ms, **extra}

    bf16_launches = bf16["epochs"]
    # The dropout cases timed: STFA's (2500, 14, 14) fp32 and bf16, and
    # FC_STGNN's over its 5 seeds (_dropout_times' order).
    drop_rows = list(drop_times.values())
    drop_stfa, drop_stfa_bf16, drop_seeds = (drop_rows[1], drop_rows[-2],
                                             drop_rows[-1])
    drop_source = "gnn_rul_tpu_torch/csrc/keyed_dropout.cu"
    drop_replaces = ("gnn_rul_tpu/train/engine.py:234 (no Pallas kernel: "
                     "flax Dropout's jax.random masks inside XLA)")
    print(json.dumps({"vectorized": vec_times}))
    print(json.dumps({"mesh": mesh}))
    print(json.dumps({"resume": resumed}))
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
              **at(fwd[KERNEL_CASES[1]], "b1000"),
              **seeds(["FC_STGNN"], 0, "dot graph", 0)),
        entry("fused_dot_graph_spmm_bwd", bwd[KERNEL_CASES[0]], bwd_max_err,
              trained["FC_STGNN"][1],
              source="gnn_rul_tpu_torch/csrc/fused_gnn_bwd.cu",
              replaces="gnn_rul_tpu/ops/pallas/fused_gnn.py:235 "
                       "(_bwd_kernel)",
              launches_per_call=trained["FC_STGNN"][1]
              / trained["FC_STGNN"][2],
              **at(bwd[KERNEL_CASES[1]], "b1000"),
              **seeds(["FC_STGNN"], 1, "dot graph bwd", 0)),
        entry("fused_lstm", lstm[lstm_shape]["fwd"], lstm_err,
              trained["LOGO"][0], source="gnn_rul_tpu_torch/csrc/fused_lstm.cu",
              replaces="gnn_rul_tpu/ops/pallas/fused_lstm.py:77 (_fwd_kernel)",
              shape="T=100 B=70 H=48", library="torch.nn.LSTM forward",
              launches_serve=served["LOGO"][4],
              launches_artifact=artifacts["LOGO"][1],
              launches_eval=trained["LOGO"][3], **hagcn("fwd", 0),
              launches_hagcn_serve=served["HAGCN"][4],
              launches_hagcn_artifact=artifacts["HAGCN"][1],
              launches_hagcn_eval=trained["HAGCN"][3],
              launches_hagcn_model2_rank=mesh["HAGCN model=2"]["launches"][0],
              **logo_bearing("fwd"), launches_logo_bearing_tier5=tier5,
              **seeds(lstm_methods, 0, logo5, 1)),
        entry("fused_lstm_bwd", lstm[lstm_shape]["bwd"], lstm_bwd_err,
              trained["LOGO"][1],
              source="gnn_rul_tpu_torch/csrc/fused_lstm_bwd.cu",
              replaces="gnn_rul_tpu/ops/pallas/fused_lstm.py:106 "
                       "(_bwd_kernel)",
              shape="T=100 B=70 H=48",
              library="torch.nn.LSTM forward+backward minus forward",
              **hagcn("bwd", 1), **logo_bearing("bwd"),
              launches_hagcn_model2_rank=mesh["HAGCN model=2"]["launches"][1],
              **seeds(lstm_methods, 1, logo5.replace("lstm", "lstm bwd"),
                      2)),
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
              **at(gat[GAT_CASES[3]], "stfa_b25000"),
              **launches_of("GAT_LSTM"), **at(gat[GAT_CASES[10]], "gat_lstm"),
              **launches_of("GDAGDL"), **at(gat[GAT_CASES[11]], "gdagdl"),
              **seeds(["STAGNN", "STFA"], 0,
                      f"gat {GROUPED_GAT[0][0]}x{GROUPED_GAT[0][1]}x"
                      f"{GROUPED_GAT[0][2]}", 3)),
        entry("keyed_dropout", drop_stfa[:5], drop_err,
              DROPOUT_EPOCH["STFA"], source=drop_source,
              replaces=drop_replaces,
              shape="(2500, 14, 14) p=0.2 (STFA's attention dropout)",
              launches_per_epoch={m: n for m, n in DROPOUT_EPOCH.items()
                                  if n},
              launches_vectorized_steps={m: v["dropout"] for m, v in
                                         vectorized.items() if v["dropout"]},
              torch_dropout_ms=drop_stfa[5],
              grouped_g5_ms=drop_seeds[0], grouped_g5_plain_ms=drop_seeds[1],
              grouped_g5_bound_ms=drop_seeds[2]),
        bf16_entry("fused_dot_graph_spmm_bf16",
                   f"gnn fwd {KERNEL_CASES[0]}", bf16["errs"]["gnn"][0],
                   bf16_launches["FC_STGNN"][0],
                   "gnn_rul_tpu_torch/csrc/fused_gnn.cu",
                   "gnn_rul_tpu/ops/pallas/fused_gnn.py:45 (_kernel), "
                   "gnn_rul_tpu/ops/pallas/fused_gnn.py:116 (_packed_kernel)",
                   launches_serve=bf16["served"]["FC_STGNN"],
                   launches_artifact=bf16["artifact"]),
        bf16_entry("fused_dot_graph_spmm_bwd_bf16",
                   f"gnn bwd {KERNEL_CASES[0]}", bf16["errs"]["gnn"][1],
                   bf16_launches["FC_STGNN"][1],
                   "gnn_rul_tpu_torch/csrc/fused_gnn_bwd.cu",
                   "gnn_rul_tpu/ops/pallas/fused_gnn.py:235 (_bwd_kernel)"),
        bf16_entry("fused_lstm_bf16", "lstm fwd (100, 70, 48)",
                   bf16["errs"]["lstm"][0], bf16_launches["LOGO"][0],
                   "gnn_rul_tpu_torch/csrc/fused_lstm.cu",
                   "gnn_rul_tpu/ops/pallas/fused_lstm.py:77 (_fwd_kernel)",
                   shape="T=100 B=70 H=48",
                   library="torch.nn.LSTM forward, bf16 (PyTorch's CUDA "
                           "RNN; cuDNN takes no bf16)"),
        bf16_entry("fused_lstm_bwd_bf16", "lstm bwd (100, 70, 48)",
                   bf16["errs"]["lstm"][1], bf16_launches["LOGO"][1],
                   "gnn_rul_tpu_torch/csrc/fused_lstm_bwd.cu",
                   "gnn_rul_tpu/ops/pallas/fused_lstm.py:106 (_bwd_kernel)",
                   shape="T=100 B=70 H=48",
                   library="torch.nn.LSTM forward+backward minus forward, "
                           "bf16 (PyTorch's CUDA RNN; cuDNN takes no bf16)"),
        bf16_entry("fused_gat_bf16", f"gat {GAT_CASES[0][:4]}",
                   bf16["errs"]["gat"], bf16_launches["STAGNN"][0],
                   "gnn_rul_tpu_torch/csrc/fused_gat.cu",
                   "gnn_rul_tpu/ops/pallas/fused_gat.py:46 (_kernel)",
                   shape="B=100 N=14 D=64 per-graph adj (STAGNN)"),
        {"name": "keyed_dropout_bf16", "route": "cuda",
         "source": drop_source, "replaces": drop_replaces,
         "launches": sum(DROPOUT_EPOCH_BF16.values()),
         "max_abs_err": drop_err, "ms": drop_stfa_bf16[0],
         "plain_ms": drop_stfa_bf16[1], "bound_ms": drop_stfa_bf16[2],
         "bound_by": drop_stfa_bf16[3], "library_ms": None,
         "fp32_ms": drop_stfa[0], "shape": "(2500, 14, 14) p=0.2",
         "launches_per_epoch": DROPOUT_EPOCH_BF16},
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
# tree since the bearing models' port has.
_HOST_TURN = """
import numpy as np, torch
import chip_smoke as c
c._device(); c._build()
for m in c.METHODS:
    dataset, sub = c.CELL[m]
    rng = np.random.default_rng(0)
    x = c._windows(dataset, rng, c.SERVE_BATCH)
    y = rng.uniform(size=(c.SERVE_BATCH, 1)).astype(np.float32)
    torch.manual_seed(0)
    engine = c.Engine(c.build_model(m, dataset, sub),
                      c.get_algorithm_spec(m),
                      c.train_params(dataset, sub, m))
    step = c._step_ms(engine, torch.from_numpy(x).cuda(),
                      torch.from_numpy(y).cuda())
    model = c.serving_model(m, dataset, sub, c._seeded_state_dict(m),
                            batch_size=c.SERVE_BATCH)
    print(f"host turn {m} [{c.SMI}]: training step {step:.4f} ms, request "
          f"of {c.SERVE_BATCH} {c._request_ms(model, x):.4f} ms", flush=True)
"""


# A turn of digests: SHA-256 of the fp32 kernels' outputs, forward and
# backward, at the dot graph's, the LSTM's and the attention's timed
# shapes, through functions every tree since PR 13's has, so two trees'
# fp32 kernels can be held bit for bit.
_DIGEST_TURN = """
import hashlib, torch
import chip_smoke as c
c._device(); c._build()

def digest(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]

k = c.fused_gnn.fused_dot_graph_spmm
for shape in [c.KERNEL_CASES[i] for i in (0, 1, 4, 5, 6)]:
    h, x, m = c._fused_inputs(*shape, seed=0)
    g = torch.randn(x.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(0))
    print("digest dot graph", shape, digest(k.forward(h, x, m)),
          digest(*k.backward(h, x, m, g, need_dmask=True)), flush=True)
lstm = c.fused_lstm.lstm_recurrence
for t, b, hh in ((100, 70, 48), (1400, 5, 120), (100, 200, 30)):
    xg, w, dys, dcf = c._lstm_inputs(t, b, hh, seed=0)
    ys, cs, cf = lstm.forward(xg, w)
    print("digest lstm", (t, b, hh), digest(ys, cs, cf),
          digest(*lstm.backward(xg, w, ys, cs, dys, dcf)), flush=True)
for case in c.GAT_CASES[:4]:
    args = c._gat_inputs(*case[:5], seed=0)
    print("digest gat", case[:4],
          digest(c.fused_gat.fused_gat.forward(*args, case[5])), flush=True)
"""

# A turn of the LSTM kernels' times at LOGO's, HAGCN's and LOGO_bearing's
# shapes.
_LSTM_TURN = ("import chip_smoke as c; c._device(); c._build(); "
              "c._lstm_times([(100, 70, 48), (1400, 5, 120), "
              "(100, 200, 30)])")


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
