"""Serving entry point (counterpart of ``gnn_rul_tpu/export.py``).

:func:`serving_model` builds a model from the hparam bank, loads a
``state_dict`` under the original torch reference's keys (the port's own,
one converted from the JAX package by
:func:`gnn_rul_tpu_torch.compat.from_jax_variables`, or the ``model_dict``
of a reference ``checkpoint.pt``) and returns a :class:`ServingModel`.

Call contract, as in the JAX package: input ``(batch, C, L)`` float32,
output ``(batch,)`` float32 normalized-RUL predictions. With a fixed
``batch_size`` the last partial batch is padded with its row 0 and the
result trimmed, so callers always get one prediction per input row.

    from gnn_rul_tpu_torch.export import serving_model
    model = serving_model("FC_STGNN", "CMAPSS", "FD001", state_dict,
                          batch_size=100)
    rul = model(x)          # x: (n, 14, 50) -> (n,)

The ported methods are ``models.MODELS``: FC_STGNN, LOGO, STAGNN and STFA.
LOGO's recurrence runs along the batch axis, so its answer for a row
depends on the other rows of the forward, padding rows included. STAGNN's
adjacency is ``cov > 0`` per window, a step function: a covariance within
rounding of 0 can give another graph, and so another answer, on the card
than on the CPU.

The model runs in ``eval()`` under ``torch.inference_mode()``, on the card
by default. The serialized artifact (``torch.export``) is not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Dict, Mapping, Optional

import numpy as np
import torch
from torch import nn

from .configs.data_configs import get_dataset_config
from .configs.hparams import model_hparams
from .models import MODELS
from .nn.tcn import TemporalConvNet


def resolve_device(device: str = "cuda") -> torch.device:
    """The device an entry point runs on. ``"cuda"`` (the default) raises
    where CUDA is absent: the port never falls back to the CPU unasked."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={device!r} but CUDA is not available; pass "
            "device='cpu' to run on the CPU")
    return dev


def build_model(method: str, dataset: str,
                dataset_id: Optional[str]) -> nn.Module:
    """The ``method`` model at the hparam bank's widths, on the CPU."""
    if method not in MODELS:
        raise NotImplementedError(
            f"{method} is not ported yet; the port's order of work is in "
            "ROADMAP.md")
    return MODELS[method](**model_hparams(dataset, dataset_id, method))


def _model_keys(state_dict: Mapping[str, Any],
                model: nn.Module) -> Dict[str, Any]:
    # A reference checkpoint's model_dict may be the algorithm's state_dict,
    # whose model keys carry a "model." prefix.
    if any(k.startswith("model.") for k in state_dict):
        keys = {k[len("model."):]: v for k, v in state_dict.items()
                if k.startswith("model.")}
    else:
        keys = dict(state_dict)
    # The reference's TemporalConvNet builds weight-normed net0/net1
    # submodules that its forward never calls; their keys are dropped, and
    # only theirs, so that any other unexpected key still fails the strict
    # load (as the JAX importer reads only the keys it names).
    dead = tuple(f"{name}.{sub}." for name, m in model.named_modules()
                 if isinstance(m, TemporalConvNet) for sub in ("net0", "net1"))
    return {k: v for k, v in keys.items() if not k.startswith(dead)}


class ServingModel:
    """``meta`` + ``__call__(x) -> (batch,)`` over a model in eval mode."""

    def __init__(self, model: nn.Module, meta: Dict[str, Any],
                 device: torch.device):
        self.model = model
        self.meta = meta
        self.device = device
        self._batch = meta["input_shape"][0]

    @torch.inference_mode()
    def __call__(self, x) -> np.ndarray:
        _, n_ch, length = self.meta["input_shape"]
        x = torch.as_tensor(x, dtype=torch.float32, device=self.device)
        if x.dim() != 3 or x.shape[1] != n_ch or x.shape[2] != length:
            raise ValueError(
                f"expected (batch, {n_ch}, {length}), got {tuple(x.shape)}")
        if self._batch is None:
            return self.model(x).reshape(-1).cpu().numpy()
        n = x.shape[0]
        bs = self._batch
        outs = []
        for i in range(0, n, bs):
            chunk = x[i:i + bs]
            if chunk.shape[0] < bs:
                pad = chunk[:1].expand(bs - chunk.shape[0], -1, -1)
                chunk = torch.cat([chunk, pad])
            outs.append(self.model(chunk).reshape(-1)[:n - i])
        return torch.cat(outs).cpu().numpy()


def serving_model(method: str, dataset: str, dataset_id: Optional[str],
                  state_dict: Mapping[str, Any], *,
                  batch_size: Optional[int] = None,
                  device: str = "cuda") -> ServingModel:
    """Build ``method`` for ``(dataset, dataset_id)``, load ``state_dict``
    strictly and return a :class:`ServingModel` on ``device``.

    ``batch_size=None`` serves any batch in one forward; a fixed
    ``batch_size`` runs every forward at that batch.
    """
    if batch_size is not None and batch_size < 1:
        raise ValueError(f"batch_size must be positive, got {batch_size}")
    dev = resolve_device(device)
    cfg = get_dataset_config(dataset)
    model = build_model(method, dataset, dataset_id)
    model.load_state_dict(_model_keys(state_dict, model), strict=True)
    model.eval().to(dev)
    meta = {
        "format": "gnn_rul_tpu_torch.serving.v1",
        "method": method,
        "dataset": dataset,
        "dataset_id": dataset_id,
        "input_shape": [None if batch_size is None else int(batch_size),
                        cfg.input_channels, cfg.sequence_len],
        "output": "normalized RUL, shape (batch,) float32",
        "device": str(dev),
    }
    return ServingModel(model, meta, dev)
