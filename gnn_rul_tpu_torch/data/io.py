"""Processed-dataset serialization (copy of ``gnn_rul_tpu/data/io.py``).

Native format: one pickle, ``{split}.npk``, holding ``{'samples', 'labels',
'max_ruls'}``, where samples and labels are arrays or, for per-unit
evaluation (N-CMAPSS, PHM2012), dicts of arrays. ``load_processed`` also
reads the original torch reference's ``train.pt`` / ``test.pt``.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict

import numpy as np
import torch


def _to_numpy(obj):
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        first = obj[0] if len(obj) else None
        if isinstance(first, (list, tuple, np.ndarray)) or np.isscalar(first):
            try:
                return np.asarray(obj)
            except Exception:
                return [_to_numpy(o) for o in obj]
        return [_to_numpy(o) for o in obj]
    if isinstance(obj, torch.Tensor):
        return obj.numpy()
    return obj


def save_processed(directory: str, split: str, samples, labels,
                   max_ruls) -> str:
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"{split}.npk")
    with open(path, "wb") as f:
        pickle.dump({"samples": _to_numpy(samples),
                     "labels": _to_numpy(labels),
                     "max_ruls": max_ruls}, f)
    return path


def load_processed(directory: str, split: str) -> Dict[str, Any]:
    """Load ``{split}.npk`` (native) or ``{split}.pt`` (reference torch)."""
    npk = os.path.join(directory, f"{split}.npk")
    if os.path.exists(npk):
        with open(npk, "rb") as f:
            return pickle.load(f)
    pt = os.path.join(directory, f"{split}.pt")
    if os.path.exists(pt):
        d = torch.load(pt, map_location="cpu", weights_only=False)
        return {"samples": _to_numpy(d["samples"]),
                "labels": _to_numpy(d["labels"]),
                "max_ruls": _to_numpy(d["max_ruls"])}
    raise FileNotFoundError(
        f"No {split}.npk or {split}.pt under {directory}")
