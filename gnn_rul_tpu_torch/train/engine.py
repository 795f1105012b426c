"""Training engine (counterpart of ``gnn_rul_tpu/train/engine.py``).

One method, one run. The dataset goes to the device once; an epoch is a
Python loop of eager train steps over one permutation of it, the full
batches first and then the last partial batch as a step of its own, so
BatchNorm sees the true batch (the reference's ``drop_last=False``). The
epoch's loss is sample-weighted and summed on the device, and read by the
host once per epoch.

The optimizer is ``torch.optim.Adam(lr, weight_decay=wd)``, the reference's
own: the decay is added into the gradient before the moments (not AdamW),
which the JAX package rebuilds as ``make_optimizer``. A method whose spec
sets ``per_batch_multistep`` (LOGO_bearing) also steps the reference's
``MultiStepLR(milestones=[5, 10, 20, 25], gamma=0.5)`` after every optimizer
step, so the lr of optimizer step t (0-based, counted across the epochs of
one run) is ``lr * 0.5 ** |{m <= t}|``, the JAX package's
``multistep_lr_schedule``; each run's engine starts again at t = 0.

The permutation comes from a ``torch.Generator`` on the device seeded from
``(seed, epoch)``. JAX's ``jax.random.permutation`` cannot be reproduced in
PyTorch, so with ``shuffle=True`` the two packages see the batches in
different orders; with ``shuffle=False`` they see the same.

Dropout is keyed (``nn/basic.py``): step ``i`` of epoch ``e`` of the run
of seed ``s`` draws its masks from :func:`~..nn.basic.step_key` ``(s, e,
i)``, so a run resumed after epoch k from the model, Adam and the
scheduler replays the uninterrupted run. A step called on its own, outside
:meth:`Engine.run_epoch`, takes the key ``(s, 0, n)`` of its engine's n-th
step.

``precision="bf16"`` runs each step's forward and backward in bfloat16 on
fp32 master parameters (``train/precision.py``); the loss, Adam and the
BatchNorm running statistics stay fp32, and :meth:`Engine.evaluate`
returns fp32.

Under a mesh (``parallel/mesh.py``) whose ``data`` axis has S > 1 ranks,
each batch's rows are split over them in contiguous blocks, the remainder
batch too (``parallel/data_axis.py``; every rank draws the same
permutation from ``(seed, epoch)`` and keeps the whole training set on its
device). Each rank's loss is its share of the global loss, its rows'
squared errors over the global row count plus its share of the auxiliary
loss; the gradients are summed over the data ranks (one all-reduce a step;
DDP's mean over ranks would be wrong on uneven blocks); BatchNorm, dropout,
the Bi-LSTM along the rows and the batch means in the losses are the
global batch's. So a step equals the single process's. :meth:`evaluate`
splits each eval batch likewise and returns the whole prediction vector on
every rank. The engine feeds each rank of a ``model`` axis above 1 the
same rows; a hooked method's graph algebra splits over it (the hook, built
by the trainer), and the engine places the parameters that the
tensor-parallel rule splits as this rank's blocks of them
(``parallel/mesh.py::shard_params``, ``parallel/model_axis.py``) before it
builds Adam, so Adam's moments are blocks too; after each backward the
replicated parameters' gradients are averaged over the model group. The
data group (``mesh.get_group("data")``) is the ranks of this rank's model
coordinate, so a split parameter's gradient is summed over the data ranks
that hold the same block.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from ..export import resolve_device
from ..nn.basic import dropout_key, step_key
from ..parallel import data_axis
from ..parallel.mesh import axis_size, shard_params
from ..parallel.model_axis import placement_of
from ..telemetry import span
from .algorithms import AlgorithmSpec, resolve_aux_weight
from .precision import bf16_forward, cast_buffer_names, check_precision


MILESTONES, GAMMA = (5, 10, 20, 25), 0.5  # reference algorithms.py:618


def mse(pred: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.mean((pred - y) ** 2)


class Engine:
    """Trains ``model`` in place. ``model(x)`` returns ``(B, 1)``
    predictions, or ``(pred, aux)`` for a model with an auxiliary loss.
    ``train_params`` carries the reference hyperparameters verbatim."""

    def __init__(self, model: nn.Module, spec: AlgorithmSpec,
                 train_params: Dict, seed: int = 0,
                 eval_batch_size: Optional[int] = None,
                 device: str = "cuda", precision: str = "fp32", mesh=None):
        self.device = resolve_device(device)
        # The data group where the data axis splits the rows, else None.
        self.data_group = (mesh.get_group("data")
                           if axis_size(mesh, "data") > 1 else None)
        self.precision = check_precision(precision)
        self.model = model.to(self.device)
        if axis_size(mesh, "model") > 1:
            shard_params(self.model, mesh)
        self.spec = spec
        self.train_params = dict(train_params)
        self.batch_size = int(train_params["batch_size"])
        self.eval_batch_size = int(eval_batch_size or self.batch_size)
        self.aux_weight = resolve_aux_weight(spec, train_params)
        self.seed = seed
        self.step_count = 0
        self._cast = cast_buffer_names(self.model)
        self.optimizer = torch.optim.Adam(
            self.model.parameters(), lr=float(train_params["learning_rate"]),
            weight_decay=float(train_params.get("weight_decay", 0.0)),
            eps=1e-8)
        self.scheduler = (torch.optim.lr_scheduler.MultiStepLR(
            self.optimizer, list(MILESTONES), GAMMA)
            if spec.per_batch_multistep else None)
        # The host arrays are kept beside their device copies, so that the
        # identity check cannot match a new array that reuses an old id.
        self._data: tuple = ()

    def _loss(self, out, y: torch.Tensor) -> torch.Tensor:
        """The MSE plus the weighted auxiliary loss; inside a split batch,
        this rank's share of the global batch's (``batch_mean``; the model
        returns its auxiliary loss as a share)."""
        pred, aux = out if isinstance(out, tuple) else (out, None)
        loss = data_axis.batch_mean((pred - y) ** 2)
        if aux is not None and self.aux_weight != 0.0:
            loss = loss + self.aux_weight * aux
        return loss

    def forward(self, x: torch.Tensor):
        """The model's forward at the engine's precision; its output in
        fp32 (``train/precision.py::bf16_forward``)."""
        if self.precision == "fp32":
            return self.model(x)
        return bf16_forward(self.model, dict(self.model.named_parameters()),
                            dict(self.model.named_buffers()), self._cast, x)

    def _shard(self, total: int) -> Optional[data_axis.RowShard]:
        """This rank's block of a batch of ``total`` rows (None off the
        data axis)."""
        if self.data_group is None:
            return None
        return data_axis.shard_of(total, self.data_group)

    def train_step(self, x: torch.Tensor, y: torch.Tensor,
                   key: Optional[int] = None) -> torch.Tensor:
        """One optimizer step on a batch on the device; returns the loss,
        detached and still on the device. ``key`` keys the step's dropout
        (:func:`~..nn.basic.step_key`; by default that of this engine's
        n-th step, ``(seed, 0, n)``). Under the data axis ``x`` and ``y``
        are the global batch, the same on every rank, and the loss is this
        rank's share of it."""
        with span("train.step"):
            return self._train_step(x, y, key)

    def _train_step(self, x: torch.Tensor, y: torch.Tensor,
                    key: Optional[int]) -> torch.Tensor:
        shard = self._shard(x.shape[0])
        if shard is not None:
            idx = shard.local_index(x.device)
            x, y = x[idx], y[idx]
        if key is None:
            key = step_key(self.seed, 0, self.step_count)
        self.step_count += 1
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        # A fill, not a copy from the host: a blocking copy would wait for
        # the card to finish the steps before.
        with dropout_key(torch.full((), key, dtype=torch.int64,
                                    device=self.device)), \
                data_axis.row_shard(shard):
            loss = self._loss(self.forward(x), y)
        loss.backward()
        if shard is not None:
            self._sum_gradients()
        placement = placement_of(self.model)
        if placement is not None:
            placement.average_replicated(self.model)
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        return loss.detach()

    def tp_sharded_param_count(self) -> int:
        """The parameters placed split over the model axis (0 without
        one)."""
        placement = placement_of(self.model)
        return 0 if placement is None else len(placement.axes)

    def _sum_gradients(self) -> None:
        """Each gradient summed over the data ranks, in one all-reduce of a
        flat buffer. Every rank ran the same forward (a stand-in row where
        it has none), so every rank holds gradients of the same
        parameters."""
        grads = [p.grad for p in self.model.parameters()
                 if p.grad is not None]
        flat = torch.cat([g.reshape(-1) for g in grads])
        torch.distributed.all_reduce(flat, group=self.data_group)
        for g, part in zip(grads, flat.split([g.numel() for g in grads])):
            g.copy_(part.view_as(g))

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
        for i, start in enumerate(range(0, n, self.batch_size)):
            idx = perm[start:start + self.batch_size]
            loss = self.train_step(x_all[idx], y_all[idx],
                                   key=step_key(self.seed, epoch, i))
            total += loss.double() * idx.shape[0]   # a share: summed below
        if self.data_group is not None:
            torch.distributed.all_reduce(total, group=self.data_group)
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
        the real rows' answers. Under the data axis each eval batch's rows
        are split as a training batch's, and the predictions gathered: every
        rank returns the whole vector."""
        with span("train.eval"):
            return self._evaluate(x_test)

    def _evaluate(self, x_test: np.ndarray) -> np.ndarray:
        n = x_test.shape[0]
        ebs = min(self.eval_batch_size, n)
        n_batches = -(-n // ebs)
        x = torch.as_tensor(np.asarray(x_test, dtype=np.float32),
                            device=self.device)
        pad = n_batches * ebs - n
        if pad:
            x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
        self.model.eval()
        shard = self._shard(ebs)
        idx = None if shard is None else shard.local_index(self.device)
        preds = []
        for i in range(n_batches):
            xb = x[i * ebs:(i + 1) * ebs]
            with data_axis.row_shard(shard):
                out = self.forward(xb if idx is None else xb[idx])
            preds.append((out[0] if isinstance(out, tuple) else out)
                         .reshape(-1))
        if shard is not None:
            preds = self._gather_predictions(torch.stack(preds), shard)
        return torch.cat(preds)[:n].cpu().numpy()

    @staticmethod
    def _gather_predictions(local: torch.Tensor,
                            shard: data_axis.RowShard):
        """Each eval batch's predictions from every rank's block of it:
        ``local`` ``(batches, rows)``, padded to the widest block for one
        all-gather; returns one ``(ebs,)`` tensor a batch."""
        pad = shard.widest - local.shape[1]
        if pad > 0:
            local = torch.cat([local, local.new_zeros(local.shape[0], pad)],
                              dim=1)
        blocks = data_axis.all_gather_blocks(local[:, :shard.widest],
                                             shard.group)
        glob = torch.cat([b[:, :count] for b, (_, count)
                          in zip(blocks, shard.blocks)], dim=1)
        return list(glob)
