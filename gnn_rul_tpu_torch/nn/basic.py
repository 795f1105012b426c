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
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Iterator, Sequence, Union

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.kernels.keyed_dropout import GOLDEN, keyed_dropout, mix_int, signed


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
    a plain ``model.train(); model(x)`` still drops out."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.p == 0.0:
            return x
        stream = _STREAM.get()
        if stream is None:
            key, call = torch.randint(-(1 << 63), (1 << 63) - 1, (),
                                      dtype=torch.int64, device=x.device), 0
        else:
            key, call = stream.key, stream.calls
            stream.calls += 1
        if self.p == 1.0:
            return torch.zeros_like(x)
        return keyed_dropout(x, key, call, self.p)


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
    updated in place) and the result rounded once to bfloat16."""
    if x.dtype != torch.bfloat16:
        return nn.BatchNorm1d.forward(bn, x)
    if bn.training:
        bn.num_batches_tracked.add_(1)
    return F.batch_norm(
        x.float(), bn.running_mean.float(), bn.running_var.float(),
        bn.weight.float(), bn.bias.float(), bn.training, bn.momentum,
        bn.eps).to(x.dtype)


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
