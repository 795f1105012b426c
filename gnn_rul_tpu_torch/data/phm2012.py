"""PHM2012 (FEMTO) bearing offline preprocessing (counterpart of
``gnn_rul_tpu/data/phm2012.py``), in numpy: no pandas.

The reference's contract (Data_Process/Data_read_PHM2012.py:10-143):
  - a fixed train/test split of the bearings per condition, and a table of
    residual RULs for the truncated test bearings;
  - each ``acc*`` file of a bearing (files sorted by name) gives one row:
    its column 4, 2,560 samples; values separated by commas, semicolons
    (some FEMTO files) or blanks;
  - per-bearing labels ``n - i + RUL_last`` over their max, in float64
    (Bearing1_4's residual RUL is 33.9);
  - min-max per column (the 2,560 sample positions) fit on the train
    bearings and applied to the test bearings, with no guard for a zero
    range, as in the reference;
  - the train rows shuffled once by ``np.random.default_rng(seed)`` (the
    reference's shuffle was unseeded);
  - test samples and labels, and ``max_ruls``, are dicts keyed by bearing.
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np

from .io import save_processed
from .parse import read_table

RUL_DICT = {
    "Bearing1_1": 0, "Bearing1_2": 0,
    "Bearing2_1": 0, "Bearing2_2": 0,
    "Bearing3_1": 0, "Bearing3_2": 0,
    "Bearing1_3": 573, "Bearing1_4": 33.9, "Bearing1_5": 161,
    "Bearing1_6": 146, "Bearing1_7": 757,
    "Bearing2_3": 753, "Bearing2_4": 139, "Bearing2_5": 309,
    "Bearing2_6": 129, "Bearing2_7": 58,
    "Bearing3_3": 82,
}

TRAIN_TEST_SPLIT = {
    "Condition1_train": ["Bearing1_1", "Bearing1_2"],
    "Condition1_test": ["Bearing1_3", "Bearing1_4", "Bearing1_5",
                        "Bearing1_6", "Bearing1_7"],
    "Condition2_train": ["Bearing2_1", "Bearing2_2"],
    "Condition2_test": ["Bearing2_3", "Bearing2_4", "Bearing2_5",
                        "Bearing2_6", "Bearing2_7"],
    "Condition3_train": ["Bearing3_1", "Bearing3_2"],
    "Condition3_test": ["Bearing3_3"],
}
_COLUMN = 4  # the horizontal acceleration (Data_read_PHM2012.py:61)


def _read_bearing(bearing_path: str) -> np.ndarray:
    """``(files, rows)`` float64: column 4 of each ``acc`` file."""
    paths = [os.path.join(bearing_path, name)
             for name in sorted(os.listdir(bearing_path)) if "acc" in name]
    return np.stack([read_table(p)[:, _COLUMN] for p in paths])


def preprocess_phm2012(data_root: str, condition_no: int,
                       out_dir: str = "Processed_dataset", seed: int = 0):
    base = os.path.join(data_root, "PHM_2012_Bearing_Datasets")
    train_list = TRAIN_TEST_SPLIT[f"Condition{condition_no}_train"]
    test_list = TRAIN_TEST_SPLIT[f"Condition{condition_no}_test"]

    x: Dict[str, np.ndarray] = {}
    y: Dict[str, np.ndarray] = {}
    max_ruls: Dict[str, float] = {}
    for split_dir in ["Learning_set", "Test_set"]:
        folder = os.path.join(base, split_dir)
        if not os.path.isdir(folder):
            continue
        for bearing in sorted(os.listdir(folder)):
            if bearing not in train_list + test_list:
                continue
            samples = _read_bearing(os.path.join(folder, bearing))
            n = samples.shape[0]
            rul_last = RUL_DICT[bearing]
            labels = np.asarray(
                [n - i + rul_last for i in range(n)], dtype=np.float64)
            mx = labels.max()
            x[bearing] = samples
            y[bearing] = labels / mx
            max_ruls[bearing] = float(mx)

    train_x = np.concatenate([x[b] for b in x if b in train_list], axis=0)
    train_y = np.concatenate([y[b] for b in y if b in train_list], axis=0)

    mx_col = train_x.max(axis=0)
    mn_col = train_x.min(axis=0)
    scale = mx_col - mn_col
    train_x = (train_x - mn_col) / scale

    test_x = {b: (x[b] - mn_col) / scale for b in x if b in test_list}
    test_y = {b: y[b] for b in y if b in test_list}

    rng = np.random.default_rng(seed)
    perm = rng.permutation(train_x.shape[0])
    train_x, train_y = train_x[perm], train_y[perm]

    out = os.path.join(out_dir, "PHM2012", f"Condition_{condition_no}")
    save_processed(out, "train", train_x.astype(np.float32),
                   train_y.astype(np.float32), max_ruls)
    save_processed(out, "test",
                   {k: v.astype(np.float32) for k, v in test_x.items()},
                   {k: v.astype(np.float32) for k, v in test_y.items()},
                   max_ruls)
    return dict(train_x=train_x, train_y=train_y, test_x=test_x,
                test_y=test_y, max_rul=max_ruls)
