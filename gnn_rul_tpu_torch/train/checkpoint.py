"""Final checkpoint in the reference's ``checkpoint.pt`` layout.

The payload is ``{"hparams", "train_params", "model_dict", "optimizer",
"epoch", "run_id"}``, every tensor on the CPU. ``model_dict`` carries the
reference's keys, so ``gnn_rul_tpu_torch.export.serving_model`` loads it and
so does the JAX package's ``import_torch_checkpoint``. The file is written
to a temporary name and renamed, so a crash mid-write leaves no partial
checkpoint. :func:`load_checkpoint` reads a checkpoint of the port or of
the reference, and :func:`load_model_dict` loads its ``model_dict`` into
a model, the keys as either writes them. Periodic asynchronous checkpoints
and resume are not ported yet (ROADMAP.md).
"""

from __future__ import annotations

import os
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from ..nn.tcn import TemporalConvNet


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


def load_checkpoint(path: str) -> Tuple[Dict[str, Any], Optional[Dict]]:
    """``(state_dict, model_hparams or None)`` from a ``checkpoint.pt``
    of the port (:func:`save_checkpoint`) or of the reference, which share
    one layout; a bare state_dict is taken as it is."""
    if path.endswith(".pkl"):
        raise ValueError(
            f"{path}: the port does not read the JAX package's "
            "checkpoint.pkl; convert its variables with "
            "gnn_rul_tpu_torch.compat.from_jax_variables and pass the "
            "state_dict to export_serving (ROADMAP.md)")
    payload = torch.load(path, map_location="cpu", weights_only=True)
    if "model_dict" not in payload:
        return payload, None
    return payload["model_dict"], payload.get("hparams")


def load_model_dict(model: nn.Module,
                    state_dict: Mapping[str, Any]) -> nn.Module:
    """Loads ``state_dict`` (the reference's keys) into ``model`` strictly
    and returns the model."""
    # A reference checkpoint's model_dict may be the algorithm's state_dict,
    # whose model keys carry a "model." prefix.
    if any(k.startswith("model.") for k in state_dict):
        keys = {k[len("model."):]: v for k, v in state_dict.items()
                if k.startswith("model.")}
    else:
        keys = dict(state_dict)
    # The reference's TemporalConvNet builds weight-normed net0/net1
    # submodules that its forward never calls, and ST_Conv layer-2 modules
    # (the model's UNCALLED); their keys are dropped, and only theirs, so
    # that any other unexpected key still fails the strict load (as the JAX
    # importer reads only the keys it names).
    dead = tuple(f"{name}.{sub}." for name, m in model.named_modules()
                 if isinstance(m, TemporalConvNet) for sub in ("net0", "net1"))
    dead += tuple(getattr(model, "UNCALLED", ()))
    model.load_state_dict({k: v for k, v in keys.items()
                           if not k.startswith(dead)}, strict=True)
    return model
