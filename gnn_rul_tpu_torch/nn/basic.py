"""The layers torch.nn lacks (counterpart of ``gnn_rul_tpu/nn/basic.py``).

``nn.Linear``, ``nn.Conv1d`` and ``nn.BatchNorm1d`` (eps 1e-5, momentum 0.1)
already have the semantics the JAX package rebuilds; only the layouts differ.

:class:`Dropout` is the port's one dropout. Its mask is a pure function of
an integer key and the element index, as JAX's ``fold_in`` keys make it:
the engines open :func:`dropout_key` around each step with the key of
``(run seed, epoch, step in the epoch)`` (:func:`step_key`), and the n-th
dropout call of the forward hashes that key with n, then with each
element's index (splitmix64; the operator of
``ops/kernels/keyed_dropout.py``, one launch a call on the card). So a
mask is the same bits on the CPU and on the card, and under
``torch.func.vmap`` a key of one entry per seed gives seed s the mask its
sequential run draws.

:class:`BatchNorm1d` and :class:`BatchNormNCL` take a bfloat16 input as
flax's ``BatchNorm`` does: statistics and normalisation in fp32, the
running statistics kept in their own dtype (fp32 in training), the output
rounded once to the input's dtype.

Under the data axis (``parallel/data_axis.py``) a batch's rows are split
over ranks: in train mode both BatchNorms normalise by the global batch's
statistics (each rank's mean and squared deviations gathered in one
collective, the running variance updated with the global n - 1), and
:class:`Dropout` keys each element by its index in the global batch, so
each rank draws the single-process mask of its rows.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Iterator, Optional, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.keyed_dropout import (GOLDEN, call_key, keyed_dropout,
                                         mix_int, signed)
from ..parallel import data_axis


# Folds a model rank into a dropout key as a call number no forward reaches.
FOLD = 1 << 32


def step_key(seed: int, epoch: int, step: int) -> int:
    """The int64 key of optimizer step ``step`` (0-based in its epoch) of
    epoch ``epoch`` of the run of seed ``seed``."""
    z = mix_int(int(seed) * GOLDEN + 1)
    z = mix_int(z + int(epoch) * GOLDEN)
    return signed(mix_int(z + int(step) * GOLDEN))


class _Stream:
    """The key of one forward and the count of dropout calls it made."""

    def __init__(self, key: torch.Tensor):
        self.key = key
        self.calls = 0


_STREAM: contextvars.ContextVar = contextvars.ContextVar(
    "gnn_rul_tpu_torch_dropout_key", default=None)


@contextlib.contextmanager
def dropout_key(key: Union[int, Sequence[int], torch.Tensor]
                ) -> Iterator[None]:
    """Keys every :class:`Dropout` call inside the block: the n-th call
    draws from ``(key, n)``. ``key`` is an int64 tensor (a scalar, or one
    entry a seed that ``torch.func.vmap`` maps) or ints for one."""
    if not isinstance(key, torch.Tensor):
        key = torch.tensor(key, dtype=torch.int64)
    token = _STREAM.set(_Stream(key))
    try:
        yield
    finally:
        _STREAM.reset(token)


class Dropout(nn.Dropout):
    """``nn.Dropout`` with the keyed mask: in train mode ``where(keep, x /
    (1 - p), 0)``, flax's form, through ``keyed_dropout``. Inside
    :func:`dropout_key` the n-th call of the block uses ``(key, n)``;
    outside one, each call draws its key from torch's global generator, so
    a plain ``model.train(); model(x)`` still drops out. Inside a split
    batch the elements count from this rank's first row's first element
    in the global batch (``x``'s leading axes the rows, outermost).
    ``fold`` (a rank of the model axis, ``parallel/graph_partition.py``)
    mixes into the key: another stream for each rank's block of a panel."""

    def forward(self, x: torch.Tensor, fold: Optional[int] = None
                ) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        stream = _STREAM.get()
        if stream is None:
            key, call = torch.randint(-(1 << 63), (1 << 63) - 1, (),
                                      dtype=torch.int64, device=x.device), 0
        else:
            key, call = stream.key, stream.calls
            stream.calls += 1
        if fold is not None:
            key = call_key(key, FOLD + fold)
        if self.p == 1.0:
            return torch.zeros_like(x)
        shard = data_axis.current()
        offset = 0 if shard is None else \
            shard.start * (x.numel() // shard.rows)
        return keyed_dropout(x, key, call, self.p, offset)


class GELU(nn.Module):
    """The exact GELU, ``x * Phi(x)``, computed as ``0.5 * x * erfc(-x /
    sqrt(2))``, the form ``jax.nn.gelu(approximate=False)`` takes.
    ``torch.nn.GELU`` computes ``0.5 * x * (1 + erf(x / sqrt(2)))``, whose
    ``1 + erf`` cancels in fp32 below x = -3: 17% off at x = -5 and 0 from
    x = -5.5 (the true value -5.9e-9 at -6), gradient included (ROADMAP.md,
    Queue 3). No parameters, so the reference's keys are unchanged where
    it replaces ``nn.GELU``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return 0.5 * x * torch.erfc(-x * (1.0 / math.sqrt(2.0)))


def _batch_norm(bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    """``bn``'s forward; a bfloat16 ``x`` is normalised in fp32 against the
    running statistics as they are stored (the fp32 ones of training are
    updated in place) and the result rounded once to bfloat16. Inside a
    split batch in train mode, :func:`_global_batch_norm`."""
    shard = data_axis.current()
    if bn.training and shard is not None and shard.size > 1:
        return _global_batch_norm(bn, x, shard)
    if x.dtype != torch.bfloat16:
        return nn.BatchNorm1d.forward(bn, x)
    if bn.training:
        bn.num_batches_tracked.add_(1)
    return F.batch_norm(
        x.float(), bn.running_mean.float(), bn.running_var.float(),
        bn.weight.float(), bn.bias.float(), bn.training, bn.momentum,
        bn.eps).to(x.dtype)


def _global_batch_norm(bn: nn.BatchNorm1d, x: torch.Tensor,
                       shard: data_axis.RowShard) -> torch.Tensor:
    """Train-mode BatchNorm over the global batch of which ``x`` (``(M,
    C)`` or ``(B, C, L)``, the rows outermost) holds this rank's rows. Each
    rank's mean and sum of squared deviations (two passes over its rows)
    are gathered in one collective and combined by Chan's rule: the global
    mean, ``sum_r n_r mean_r / n``, and the global sum of squared
    deviations, ``sum_r (m2_r + n_r (mean_r - mean)^2)``, with the counts
    ``n_r`` from the blocks (0 for a stand-in row); the biased variance
    normalises, the running variance takes ``var * n / (n - 1)``. In fp32
    (fp64 for an fp64 ``x``), the output in ``x``'s dtype."""
    dims = [0] + list(range(2, x.dim()))
    shape = [1, -1] + [1] * (x.dim() - 2)
    xf = x.to(torch.promote_types(x.dtype, torch.float32))
    per_row = xf.numel() // xf.shape[1] // shard.rows
    local = xf.mean(dims)
    dev = xf - local.reshape(shape)
    stats = data_axis.all_gather_stats(
        torch.stack([local, (dev * dev).sum(dims) * shard.weight]),
        shard.group)                                      # (ranks, 2, C)
    counts = torch.tensor([per_row * count for _, count in shard.blocks],
                          dtype=xf.dtype, device=xf.device)[:, None]
    n = per_row * shard.total
    mean = (counts * stats[:, 0]).sum(0) / n
    var = (stats[:, 1] + counts * (stats[:, 0] - mean) ** 2).sum(0) / n
    out = (xf - mean.reshape(shape)) * torch.rsqrt(var + bn.eps).reshape(shape)
    if bn.affine:
        out = out * bn.weight.to(xf.dtype).reshape(shape) \
            + bn.bias.to(xf.dtype).reshape(shape)
    if bn.track_running_stats:
        with torch.no_grad():
            bn.num_batches_tracked.add_(1)
            m = (1.0 / float(bn.num_batches_tracked) if bn.momentum is None
                 else bn.momentum)
            bn.running_mean.mul_(1 - m).add_(
                mean.detach().to(bn.running_mean.dtype), alpha=m)
            bn.running_var.mul_(1 - m).add_(
                (var.detach() * (n / max(n - 1, 1))).to(bn.running_var.dtype),
                alpha=m)
    return out.to(x.dtype)


class BatchNorm1d(nn.BatchNorm1d):
    """BatchNorm over the LAST axis: the leading axes are flattened into the
    batch, as the JAX ``BatchNorm1d`` reduces over every axis but the last."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _batch_norm(self, x.reshape(-1, x.shape[-1])).reshape(x.shape)


class BatchNormNCL(nn.BatchNorm1d):
    """BatchNorm on ``(B, C, L)``, per channel over ``(B, L)``: torch's own
    layout, kept as a class so each JAX layer has a counterpart."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 3:
            raise ValueError(f"BatchNormNCL expects (B, C, L), got "
                             f"{tuple(x.shape)}")
        return _batch_norm(self, x)


class MLP(nn.Sequential):
    """``Linear`` layers with a ReLU between them and none after the last
    (the JAX ``MLP``), as the reference's ``nn.Sequential``: its Linears
    are ``0``, ``2``, ``4`` ..."""

    def __init__(self, in_features: int, features):
        layers = []
        for i, out_features in enumerate(features):
            if i:
                layers.append(nn.ReLU())
            layers.append(nn.Linear(in_features, out_features))
            in_features = out_features
        super().__init__(*layers)
