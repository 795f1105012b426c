"""XJTU-SY bearing offline preprocessing (counterpart of
``gnn_rul_tpu/data/xjtu_sy.py``), in numpy: no pandas.

The reference's contract (Data_Process/Data_read_XJTU_SY.py:10-169):
  - 3 conditions x 5 bearings; each bearing's minute count comes from the
    table ``RUL_CONDITION_BEARING``;
  - each minute's csv (one header line) gives the column named
    ``Horizontal_vibration_signals``, parsed correctly rounded in float64,
    then every ``downsampling``-th sample; labels ``(end - i) / end``;
  - leave one bearing out: for each test bearing, train on the other four;
  - min-max per position fit on the train split; the train rows shuffled
    once (the reference's shuffle was unseeded), by one
    ``np.random.default_rng(seed)`` shared by the five splits in test-bearing
    order;
  - artifacts under ``Condition_i/Testing_bearing_j/``.
"""

from __future__ import annotations

import os

import numpy as np

from .io import save_processed
from .parse import read_header, read_table

RUL_CONDITION_BEARING = [[123, 161, 158, 122, 52],
                         [491, 161, 533, 42, 339],
                         [2538, 2496, 371, 1515, 114]]
CONDITION_FOLDERS = ["35Hz12kN", "37.5Hz11kN", "40Hz10kN"]
_COLUMN = "Horizontal_vibration_signals"


def _read_bearing(folder: str, minutes: int, downsampling: int) -> np.ndarray:
    """``(minutes, samples // downsampling)`` float64: the horizontal
    column of each minute's file, looked up by name in each file."""
    paths = [os.path.join(folder, f"{i}.csv") for i in range(1, minutes + 1)]
    return np.stack([
        read_table(p, skip_rows=1)[::downsampling,
                                   read_header(p).index(_COLUMN)]
        for p in paths])


def preprocess_xjtu_sy(data_root: str, condition_no: int,
                       downsampling: int = 1,
                       out_dir: str = "Processed_dataset", seed: int = 0):
    base = os.path.join(data_root, "XJTU-SY_Bearing_Datasets",
                        CONDITION_FOLDERS[condition_no - 1])
    ruls = RUL_CONDITION_BEARING[condition_no - 1]

    x, y = {}, {}
    for b in range(1, 6):
        minutes = ruls[b - 1]
        folder = os.path.join(base, f"Bearing{condition_no}_{b}")
        x[b] = _read_bearing(folder, minutes, downsampling)
        y[b] = np.asarray([(minutes - i) / minutes
                           for i in range(1, minutes + 1)], dtype=np.float64)

    results = {}
    rng = np.random.default_rng(seed)
    for test_b in range(1, 6):
        train_x = np.concatenate([x[b] for b in x if b != test_b], axis=0)
        train_y = np.concatenate([y[b] for b in y if b != test_b], axis=0)
        test_x = x[test_b]
        test_y = y[test_b]

        mn = train_x.min(axis=0)
        scale = train_x.max(axis=0) - mn
        train_x = (train_x - mn) / scale
        test_x = (test_x - mn) / scale

        perm = rng.permutation(train_x.shape[0])
        train_x, train_y = train_x[perm], train_y[perm]

        out = os.path.join(out_dir, "XJTU_SY", f"Condition_{condition_no}",
                           f"Testing_bearing_{test_b}")
        max_rul = float(ruls[test_b - 1])
        save_processed(out, "train", train_x.astype(np.float32),
                       train_y.astype(np.float32), max_rul)
        save_processed(out, "test", test_x.astype(np.float32),
                       test_y.astype(np.float32), max_rul)
        results[test_b] = dict(train_x=train_x, train_y=train_y,
                               test_x=test_x, test_y=test_y, max_rul=max_rul)
    return results
