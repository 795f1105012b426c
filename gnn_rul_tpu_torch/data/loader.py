"""Processed-dataset loading (copy of ``gnn_rul_tpu/data/loader.py``).

Plain numpy arrays, normalized once at load time; the training engine puts
them on the device once. Layout rules of the reference's Load_Dataset:

  - 2-D samples (N, L) gain a trailing axis -> (N, L, 1)
  - the channel axis is forced to axis 1 (whichever of axes 1/2 is smaller)
  - 1-D labels gain a trailing axis -> (N, 1)

Test data may be a dict (N-CMAPSS per unit, PHM2012 per bearing), and then
``max_ruls`` is a dict too.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Any, Dict, Optional, Union

import numpy as np

from .io import load_processed


def normalize_layout(x: np.ndarray, y: np.ndarray):
    x = np.asarray(x, dtype=np.float32)
    y = np.asarray(y, dtype=np.float32)
    if x.ndim < 3:
        x = x[..., None]
    if x.shape.index(min(x.shape[1], x.shape[2])) != 1:
        x = np.transpose(x, (0, 2, 1))
    if y.ndim == 1:
        y = y[:, None]
    return x, y


@dataclasses.dataclass
class DataBundle:
    train_x: np.ndarray
    train_y: np.ndarray
    # one test set: (x, y); per-key test sets: {key: (x, y)}
    test: Union[tuple, Dict[Any, tuple]]
    max_ruls: Union[float, Dict[Any, float]]

    @property
    def is_dict_test(self) -> bool:
        return isinstance(self.test, dict)


def load_dataset(data_path: str) -> DataBundle:
    """Load the train/test artifacts of a processed-dataset directory
    (native .npk or reference .pt)."""
    train = load_processed(data_path, "train")
    test = load_processed(data_path, "test")
    train_x, train_y = normalize_layout(
        np.asarray(train["samples"]), np.asarray(train["labels"]))
    if isinstance(test["samples"], dict):
        bundle_test: Union[tuple, Dict] = {
            key: normalize_layout(np.asarray(test["samples"][key]),
                                  np.asarray(test["labels"][key]))
            for key in test["samples"]}
    else:
        bundle_test = normalize_layout(np.asarray(test["samples"]),
                                       np.asarray(test["labels"]))
    return DataBundle(train_x, train_y, bundle_test, train["max_ruls"])


def resolve_data_path(data_root: str, dataset: str,
                      dataset_id: Optional[str] = None,
                      bearing_id: Optional[str] = None) -> str:
    """The reference's path nesting (trainer.py:42-47)."""
    if dataset == "NCMAPSS":
        return os.path.join(data_root, dataset)
    if dataset in ("CMAPSS", "PHM2012"):
        return os.path.join(data_root, dataset, dataset_id)
    if dataset == "XJTU_SY":
        return os.path.join(data_root, dataset, dataset_id, bearing_id)
    raise ValueError(f"Unknown dataset {dataset}")
