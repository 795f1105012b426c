"""Cross-cutting utilities (counterpart of ``gnn_rul_tpu/utils.py``).

  - :class:`AverageMeter`: running averages (reference utils.py:44-60);
  - :func:`param_count` and :func:`complexity_computation`: the parameter
    count and the operations of one eval forward, counted by
    ``torch.utils.flop_counter.FlopCounterMode`` (reference utils.py:20-40
    used thop);
  - :func:`seed_everything` and :func:`prng_seq`: reproducibility;
  - :func:`profile_trace`: a ``torch.profiler`` trace that TensorBoard
    reads;
  - :func:`debug_nans`: ``torch.autograd.set_detect_anomaly``;
  - :func:`device_sync`: a synchronised read of a device value, for
    honest timing.

The operation count is torch's convention: 2 operations a multiply-add of
the products and convolutions (thop's 2 x MACs, as the reference reports),
plus the counts registered below for the port's three operators, the same
on the CPU (their plain versions) and on the card (their kernels). It is
not XLA's cost analysis, which the JAX package reports and which counts
every elementwise operation too; the two do not compare. Elementwise work
outside the operators, and cuDNN's RNN calls on the card, are not counted.
"""

from __future__ import annotations

import contextlib
import random
from typing import Iterator, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode, register_flop_formula

# The operators whose counts are registered below.
from .ops.kernels import fused_gat, fused_gnn, fused_lstm  # noqa: F401
from .ops.kernels.keyed_dropout import GOLDEN, mix_int, signed


class AverageMeter:
    """Computes and stores the average and current value."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


def param_count(model: nn.Module) -> int:
    """The number of parameter elements (BatchNorm's running statistics are
    buffers, not counted, as flax keeps them out of ``params``)."""
    return sum(p.numel() for p in model.parameters())


# The operators' operation counts, as chip_smoke.py's bounds count them.
@register_flop_formula(torch.ops.gnn_rul_tpu_torch.fused_dot_graph_spmm)
def _dot_graph_flops(h_shape, x_shape, mask_shape, out_shape=None) -> int:
    """``2 B N^2 (D + F)``: the scores ``h h^T`` and the aggregation."""
    b, n, d = h_shape
    return 2 * b * n * n * (d + x_shape[-1])


@register_flop_formula(torch.ops.gnn_rul_tpu_torch.lstm_recurrence)
def _lstm_flops(xg_shape, w_hh_shape, out_shape=None) -> int:
    """``(8 H^2 + 14 H)`` a (step, direction, column): the recurrent
    product, the gate additions, the activations and the cell."""
    h = w_hh_shape[-2]
    rows = int(np.prod(xg_shape)) // (4 * h)
    return rows * (8 * h * h + 14 * h)


@register_flop_formula(torch.ops.gnn_rul_tpu_torch.fused_gat)
def _gat_flops(wh_shape, f1_shape, f2_shape, adj_shape, bias_shape, slope,
               out_shape=None) -> int:
    """``2 B N^2 D + 6 B N^2``: the product with wh, and the logits, the
    leaky_relu, the exponent, the normalisation and the mask."""
    b, n, d = wh_shape
    return 2 * b * n * n * d + 6 * b * n * n


def complexity_computation(model: nn.Module, input_channels: int,
                           sequence_len: int,
                           device=None) -> Tuple[int, int]:
    """``(flops, params)`` of one eval forward of ``model`` on a ``(1, C,
    L)`` input of zeros (reference utils.py:20-28), the operations counted
    by ``FlopCounterMode`` in torch's convention (module docstring). The
    input goes to ``device`` (default: the model's). The model is left in
    eval mode."""
    if device is None:
        device = next(model.parameters()).device
    x = torch.zeros((1, input_channels, sequence_len), device=device)
    model.eval()
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(x)
    return counter.get_total_flops(), param_count(model)


def seed_everything(seed: int) -> None:
    """Seeds Python's, numpy's and torch's generators (the reference's
    utils.py:63-69)."""
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)


def prng_seq(seed: int, generators: bool = False,
             device: str = "cpu") -> Iterator:
    """A deterministic, endless sequence of independent int64 keys
    (splitmix64 of ``seed`` and the position), or of ``torch.Generator``
    objects on ``device`` seeded by them: the same sequence for the same
    seed."""
    i = 0
    while True:
        key = signed(mix_int(mix_int(int(seed) * GOLDEN + 1) + i * GOLDEN))
        i += 1
        if generators:
            gen = torch.Generator(device=device)
            gen.manual_seed(key & ((1 << 63) - 1))
            yield gen
        else:
            yield key


@contextlib.contextmanager
def profile_trace(log_dir: str, record_shapes: bool = True):
    """A ``torch.profiler`` trace of the block, CPU and (where CUDA is
    present) CUDA activity, written under ``log_dir`` as
    ``<worker>.<time>.pt.trace.json`` by
    ``torch.profiler.tensorboard_trace_handler``: TensorBoard's profiler
    plugin, ``chrome://tracing`` and Perfetto read it. The port's spans
    (``telemetry``) are in it. ``record_shapes=False`` under
    ``torch.func.vmap``: recording the input shapes there keeps every
    batched input alive until the profiler stops."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities, record_shapes=record_shapes,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(log_dir)):
        yield
        if torch.cuda.is_available():
            torch.cuda.synchronize()


@contextlib.contextmanager
def debug_nans(enable: bool = True):
    """``torch.autograd.set_detect_anomaly(enable)`` inside the block: a
    backward that makes a NaN raises at the operation that made it."""
    with torch.autograd.set_detect_anomaly(enable):
        yield


def device_sync(x) -> float:
    """Waits for the card (``torch.cuda.synchronize``, where CUDA is
    present) and returns the first element of ``x`` as a float: a real
    round trip, for honest timing."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return float(torch.as_tensor(x).reshape(-1)[0])
