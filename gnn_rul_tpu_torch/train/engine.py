"""Training engine (counterpart of ``gnn_rul_tpu/train/engine.py``).

One method, one run. The dataset goes to the device once; an epoch is a
Python loop of eager train steps over one permutation of it, the full
batches first and then the last partial batch as a step of its own, so
BatchNorm sees the true batch (the reference's ``drop_last=False``). The
epoch's loss is sample-weighted and summed on the device, and read by the
host once per epoch.

The optimizer is ``torch.optim.Adam(lr, weight_decay=wd)``, the reference's
own: the decay is added into the gradient before the moments (not AdamW),
which the JAX package rebuilds as ``make_optimizer``.

The permutation comes from a ``torch.Generator`` on the device seeded from
``(seed, epoch)``. JAX's ``jax.random.permutation`` cannot be reproduced in
PyTorch, so with ``shuffle=True`` the two packages see the batches in
different orders; with ``shuffle=False`` they see the same.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..export import resolve_device
from .algorithms import AlgorithmSpec, resolve_aux_weight


def mse(pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - y) ** 2)


class Engine:
    """Trains ``model`` in place. ``model(x)`` returns ``(B, 1)``
    predictions, or ``(pred, aux)`` for a model with an auxiliary loss.
    ``train_params`` carries the reference hyperparameters verbatim."""

    def __init__(self, model: nn.Module, spec: AlgorithmSpec,
                 train_params: Dict, seed: int = 0,
                 eval_batch_size: Optional[int] = None,
                 device: str = "cuda"):
        if spec.per_batch_multistep:
            raise NotImplementedError(
                "the per-batch MultiStepLR arrives with LOGO_bearing "
                "(ROADMAP.md)")
        self.device = resolve_device(device)
        self.model = model.to(self.device)
        self.spec = spec
        self.train_params = dict(train_params)
        self.batch_size = int(train_params["batch_size"])
        self.eval_batch_size = int(eval_batch_size or self.batch_size)
        self.aux_weight = resolve_aux_weight(spec, train_params)
        self.seed = seed
        self.optimizer = torch.optim.Adam(
            self.model.parameters(), lr=float(train_params["learning_rate"]),
            weight_decay=float(train_params.get("weight_decay", 0.0)),
            eps=1e-8)
        # The host arrays are kept beside their device copies, so that the
        # identity check cannot match a new array that reuses an old id.
        self._data: tuple = ()

    def _loss(self, out, y: torch.Tensor) -> torch.Tensor:
        pred, aux = out if isinstance(out, tuple) else (out, None)
        loss = mse(pred, y)
        if aux is not None and self.aux_weight != 0.0:
            loss = loss + self.aux_weight * aux
        return loss

    def train_step(self, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """One optimizer step on a batch on the device; returns the loss,
        detached and still on the device."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        loss = self._loss(self.model(x), y)
        loss.backward()
        self.optimizer.step()
        return loss.detach()

    def _device_data(self, x_train: np.ndarray, y_train: np.ndarray):
        if not self._data or self._data[0] is not x_train \
                or self._data[1] is not y_train:
            self._data = (x_train, y_train,
                          torch.as_tensor(x_train, device=self.device),
                          torch.as_tensor(y_train, device=self.device))
        return self._data[2:]

    def run_epoch(self, x_train: np.ndarray, y_train: np.ndarray, epoch: int,
                  shuffle: bool) -> float:
        """One epoch; returns the sample-weighted mean loss. ``epoch`` is
        1-based, as in the reference trainer."""
        n = x_train.shape[0]
        x_all, y_all = self._device_data(x_train, y_train)
        if shuffle:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.seed * 1_000_003 + epoch)
            perm = torch.randperm(n, generator=gen, device=self.device)
        else:
            perm = torch.arange(n, device=self.device)
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        for start in range(0, n, self.batch_size):
            idx = perm[start:start + self.batch_size]
            loss = self.train_step(x_all[idx], y_all[idx])
            total += loss.double() * idx.shape[0]
        return float(total) / max(n, 1)

    @torch.no_grad()
    def evaluate(self, x_test: np.ndarray) -> np.ndarray:
        """Predictions for the whole test set, in eval mode. The set is
        padded with its last row to a multiple of the eval batch and the
        padding's predictions are dropped, as the JAX engine does. The
        padding leaves the real rows' answers unchanged only in a model
        without a recurrence along the batch axis (running BN statistics,
        no dropout): LOGO's and HAGCN's Bi-LSTMs run over the rows of the
        batch, so their backward direction carries the padding rows into
        the real rows' answers."""
        n = x_test.shape[0]
        ebs = min(self.eval_batch_size, n)
        n_batches = -(-n // ebs)
        x = torch.as_tensor(np.asarray(x_test, dtype=np.float32),
                            device=self.device)
        pad = n_batches * ebs - n
        if pad:
            x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
        self.model.eval()
        preds = []
        for i in range(n_batches):
            out = self.model(x[i * ebs:(i + 1) * ebs])
            preds.append((out[0] if isinstance(out, tuple) else out)
                         .reshape(-1))
        return torch.cat(preds)[:n].cpu().numpy()
