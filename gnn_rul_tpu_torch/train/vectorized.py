"""Seed-parallel training: the reference's runs of one experiment as one
program (counterpart of ``gnn_rul_tpu/train/vectorized.py``).

The reference's protocol is ``num_runs`` runs, seed = run index, each 81
epochs at batch 100. At batch 100 most models leave the card idle most of
each step, waiting on the host. :class:`VectorizedEngine` runs all seeds
at once: ``torch.func.vmap`` over a leading seed axis of the stacked
parameters, BatchNorm statistics and each seed's own batch, so every
launch of a step does the work of all seeds. The port's three registered
operators fold the seed axis into their kernels' batch axis and the
seeds' weights into a group axis (``ops/kernels/batching.py``): one launch
of each kernel for all seeds. The library's LSTM and GRU run each seed's
call in turn (``nn/recurrent.py::library_rnn``).

Per seed it is the sequential :class:`~.engine.Engine`: each model built
after ``torch.manual_seed(seed)``, as ``Trainer`` builds it; each seed's
permutation from ``seed * 1_000_003 + epoch``; the full batches first,
then the remainder as a step of its own; the loss ``MSE + aux_weight *
aux`` of each seed; one ``torch.optim.Adam`` over the stacked tensors,
whose update (the reference's decay added into the gradient) is
elementwise, so it is S Adams; LOGO_bearing's per-batch MultiStepLR, every
seed at the same step. The forward runs under vmap and the backward is an
ordinary ``backward()`` of the sum of the seeds' losses, outside vmap (the
operators' registered backwards cannot run under ``torch.func.grad``).
Dropout is keyed (``nn/basic.py``): each step passes the (S,) keys of
:func:`~..nn.basic.step_key` ``(seed, epoch, step)`` into the vmapped
loss, so seed s draws exactly the masks of its sequential run, and the
vmap runs with ``randomness="error"``: no draw from a generator. The seeds
differ from S sequential runs only by the rounding of batched products.
``precision="bf16"`` casts each seed's parameters, constants and input as
the sequential :class:`~.engine.Engine` does (``train/precision.py``).
"""

from __future__ import annotations

import copy
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn
from torch.func import functional_call, stack_module_state, vmap

from ..export import resolve_device
from ..nn.basic import dropout_key, step_key
from ..telemetry import span
from .algorithms import AlgorithmSpec, resolve_aux_weight
from .engine import GAMMA, MILESTONES, mse
from .precision import bf16_forward, cast_buffer_names, check_precision


def _constant_names(model: nn.Module) -> List[str]:
    """The model's non-persistent buffers (FC_STGNN's decay masks, its
    positional encoding): constants, not state."""
    return [f"{prefix}.{name}" if prefix else name
            for prefix, module in model.named_modules()
            for name in module._non_persistent_buffers_set]


class VectorizedEngine:
    """Trains ``len(seeds)`` models of ``model_fn()`` in lockstep. Every
    tensor of the state carries a leading seed axis S; ``run_epoch``
    returns the S mean losses and ``evaluate`` (S, n) predictions."""

    def __init__(self, model_fn: Callable[[], nn.Module],
                 spec: AlgorithmSpec, train_params: Dict,
                 seeds: List[int], eval_batch_size: Optional[int] = None,
                 device: str = "cuda", precision: str = "fp32"):
        self.device = resolve_device(device)
        self.precision = check_precision(precision)
        self.step_count = 0
        self.spec = spec
        self.train_params = dict(train_params)
        self.batch_size = int(train_params["batch_size"])
        self.eval_batch_size = int(eval_batch_size or self.batch_size)
        self.aux_weight = resolve_aux_weight(spec, train_params)
        self.seeds = [int(s) for s in seeds]
        models = []
        for seed in self.seeds:
            torch.manual_seed(seed)
            models.append(model_fn().to(self.device))
        # The structure functional_call runs; every tensor is replaced.
        self.model = models[0]
        self._cast = cast_buffer_names(self.model)
        constants = _constant_names(self.model)
        params, buffers = stack_module_state(models)
        self.params = params
        self.buffers = {k: v for k, v in buffers.items()
                        if k not in constants}
        named = dict(self.model.named_buffers())
        self.constants = {k: named[k] for k in constants}
        for name in constants:
            if not torch.equal(buffers[name],
                               buffers[name][:1].expand_as(buffers[name])):
                raise ValueError(f"VectorizedEngine: the constant buffer "
                                 f"{name} differs between seeds")
        self.optimizer = torch.optim.Adam(
            self.params.values(), lr=float(train_params["learning_rate"]),
            weight_decay=float(train_params.get("weight_decay", 0.0)),
            eps=1e-8)
        self.scheduler = (torch.optim.lr_scheduler.MultiStepLR(
            self.optimizer, list(MILESTONES), GAMMA)
            if spec.per_batch_multistep else None)
        self._data: tuple = ()

    def _forward(self, params, buffers, x):
        if self.precision == "fp32":
            return functional_call(self.model,
                                   (params, buffers, self.constants), (x,))
        return bf16_forward(self.model, params,
                            {**buffers, **self.constants}, self._cast, x)

    def _loss(self, params, buffers, x, y, key):
        with dropout_key(key):
            out = self._forward(params, buffers, x)
        pred, aux = out if isinstance(out, tuple) else (out, None)
        loss = mse(pred, y)
        if aux is not None and self.aux_weight != 0.0:
            loss = loss + self.aux_weight * aux
        return loss

    def train_step(self, x: torch.Tensor, y: torch.Tensor,
                   keys: Optional[List[int]] = None) -> torch.Tensor:
        """One optimizer step of every seed on its batch, ``x (S, B, ...)``
        and ``y (S, B, 1)`` on the device; returns the (S,) losses,
        detached and still on the device. ``keys`` are the seeds' dropout
        keys (by default those of each seed's n-th step, ``(seed, 0,
        n)``, as the sequential Engine's)."""
        with span("train.step"):
            return self._train_step(x, y, keys)

    def _train_step(self, x: torch.Tensor, y: torch.Tensor,
                    keys: Optional[List[int]]) -> torch.Tensor:
        if keys is None:
            keys = [step_key(s, 0, self.step_count) for s in self.seeds]
        self.step_count += 1
        self.model.train()
        self.optimizer.zero_grad(set_to_none=True)
        # Fills, not a copy from the host (which would wait for the card).
        keys = torch.stack([torch.full((), k, dtype=torch.int64,
                                       device=self.device) for k in keys])
        losses = vmap(self._loss, randomness="error")(
            self.params, self.buffers, x, y, keys)
        losses.sum().backward()
        self.optimizer.step()
        if self.scheduler is not None:
            self.scheduler.step()
        return losses.detach()

    def _device_data(self, x_train: np.ndarray, y_train: np.ndarray):
        if not self._data or self._data[0] is not x_train \
                or self._data[1] is not y_train:
            self._data = (x_train, y_train,
                          torch.as_tensor(x_train, device=self.device),
                          torch.as_tensor(y_train, device=self.device))
        return self._data[2:]

    def permutations(self, n: int, epoch: int, shuffle: bool) -> torch.Tensor:
        """(S, n): each seed's order of the epoch, the sequential
        ``Engine``'s."""
        if not shuffle:
            return torch.arange(n, device=self.device).expand(
                len(self.seeds), n)
        perms = []
        for seed in self.seeds:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(seed * 1_000_003 + epoch)
            perms.append(torch.randperm(n, generator=gen, device=self.device))
        return torch.stack(perms)

    def run_epoch(self, x_train: np.ndarray, y_train: np.ndarray, epoch: int,
                  shuffle: bool) -> np.ndarray:
        """One epoch of every seed; returns the (S,) sample-weighted mean
        losses. ``epoch`` is 1-based, as in the reference trainer."""
        n = x_train.shape[0]
        x_all, y_all = self._device_data(x_train, y_train)
        perm = self.permutations(n, epoch, shuffle)
        total = torch.zeros(len(self.seeds), dtype=torch.float64,
                            device=self.device)
        for i, start in enumerate(range(0, n, self.batch_size)):
            idx = perm[:, start:start + self.batch_size]
            loss = self.train_step(x_all[idx], y_all[idx],
                                   [step_key(s, epoch, i)
                                    for s in self.seeds])
            total += loss.double() * idx.shape[1]
        return total.cpu().numpy() / max(n, 1)

    @torch.no_grad()
    def evaluate(self, x_test: np.ndarray) -> np.ndarray:
        """(S, n) predictions of the whole test set, in eval mode, padded
        and trimmed as ``Engine.evaluate`` pads them."""
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
        forward = vmap(self._forward, in_dims=(0, 0, None),
                       randomness="error")
        preds = []
        for i in range(n_batches):
            out = forward(self.params, self.buffers,
                          x[i * ebs:(i + 1) * ebs])
            preds.append((out[0] if isinstance(out, tuple) else out)
                         .reshape(len(self.seeds), -1))
        return torch.cat(preds, dim=1)[:, :n].cpu().numpy()

    def _state_names(self) -> List[str]:
        return list(self.model.state_dict().keys())

    def slice_state(self, s: int) -> Dict[str, torch.Tensor]:
        """Seed ``s``'s state dict, on the CPU: it loads strictly into the
        sequential model."""
        state = {**self.params, **self.buffers}
        return {k: state[k][s].detach().cpu().clone()
                for k in self._state_names()}

    def slice_optimizer(self, s: int) -> Dict:
        """Seed ``s``'s Adam state dict, for an Adam over the sequential
        model's ``parameters()`` (the same order as the stacked ones)."""
        full = self.optimizer.state_dict()
        state = {i: {k: (v[s].detach().cpu().clone() if v.dim() else v)
                     for k, v in st.items()}
                 for i, st in full["state"].items()}
        return {"state": state,
                "param_groups": copy.deepcopy(full["param_groups"])}

    @torch.no_grad()
    def load_seed(self, s: int, state_dict: Dict[str, torch.Tensor]) -> None:
        """Sets seed ``s``'s parameters and statistics from a state dict of
        the sequential model (its keys, every one)."""
        state = {**self.params, **self.buffers}
        names = self._state_names()
        if set(state_dict) != set(names):
            raise ValueError(f"load_seed: keys differ from the model's: "
                             f"{sorted(set(state_dict) ^ set(names))}")
        for k in names:
            state[k][s].copy_(torch.as_tensor(state_dict[k]))
