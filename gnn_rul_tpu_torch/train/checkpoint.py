"""Final checkpoint in the reference's ``checkpoint.pt`` layout.

The payload is ``{"hparams", "train_params", "model_dict", "optimizer",
"epoch", "run_id"}``, every tensor on the CPU. ``model_dict`` carries the
reference's keys, so ``gnn_rul_tpu_torch.export.serving_model`` loads it and
so does the JAX package's ``import_torch_checkpoint``. The file is written
to a temporary name and renamed, so a crash mid-write leaves no partial
checkpoint. Periodic asynchronous checkpoints and resume are not ported yet
(ROADMAP.md).
"""

from __future__ import annotations

import os
from typing import Any, Dict

import torch
from torch import nn


def _to_cpu(obj):
    if isinstance(obj, torch.Tensor):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def save_checkpoint(path: str, model: nn.Module,
                    optimizer: torch.optim.Optimizer, *, epoch: int,
                    run_id: int, hparams: Dict[str, Any],
                    train_params: Dict[str, Any]) -> str:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {
        "hparams": dict(hparams),
        "train_params": dict(train_params),
        "model_dict": _to_cpu(model.state_dict()),
        "optimizer": _to_cpu(optimizer.state_dict()),
        "epoch": int(epoch),
        "run_id": int(run_id),
    }
    tmp = f"{path}.tmp"
    torch.save(payload, tmp)
    os.replace(tmp, path)
    return path
