"""C-MAPSS offline preprocessing (counterpart of ``gnn_rul_tpu/data/cmapss.py``),
in numpy: no pandas.

The reference's contract (Data_Process/Data_read_CMAPSS.py:18-330):
  - read train_/test_/RUL_FD00x.txt: space-separated, each line ending in
    two blanks (pandas reads two empty columns there and drops them; the
    parser here reads the 26 columns), the RUL file one value and a blank
    a line;
  - keep 14 of the 21 sensors (drop the flat s1, s5, s6, s10, s16, s18,
    s19);
  - labels: the RUL capped at ``max_rul`` (125), over ``max_rul``, in
    float64, then float32;
  - min-max per operating condition, the groups of setting1 rounded to one
    decimal (numpy's half-to-even), fit on the train group and applied to
    the test rows of the same condition; a test row whose condition no
    train row has keeps its raw values; a zero range scales by 1;
  - train: every window of ``seq_len`` at stride 1 per engine, cast to
    float32 before windowing, labelled at the window's last row; an engine
    shorter than the window gives none;
  - test: one window per engine, its last ``seq_len`` rows, head-padded
    with its first row where it is shorter; labelled at its last row.

Samples are ``(num_windows, seq_len, 14)`` float32; the loader moves the
channels to axis 1.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from .io import save_processed
from .parse import read_table, window_series

SENSOR_COLS = ["s2", "s3", "s4", "s7", "s8", "s9", "s11", "s12", "s13",
               "s14", "s15", "s17", "s20", "s21"]
_ALL_COLS = ["id", "cycle", "setting1", "setting2", "setting3"] + [
    f"s{i}" for i in range(1, 22)]
_SENSORS = [_ALL_COLS.index(c) for c in SENSOR_COLS]
_ID, _CYCLE, _SETTING1 = 0, 1, 2


def _read_txt(path: str) -> np.ndarray:
    """The 26 columns of a train_/test_ file in float64, rows sorted by
    (id, cycle)."""
    table = read_table(path)
    if table.shape[1] != len(_ALL_COLS):
        raise ValueError(f"{path}: {table.shape[1]} columns, expected "
                         f"{len(_ALL_COLS)}")
    return table[np.lexsort((table[:, _CYCLE], table[:, _ID]))]


def _per_condition_minmax(train: np.ndarray, test: np.ndarray
                          ) -> Tuple[np.ndarray, np.ndarray]:
    """The sensors of ``train`` and ``test`` min-max scaled per rounded
    setting1 group of ``train`` (a zero range scales by 1); test rows of a
    condition absent from train keep their raw values."""
    train_out = train[:, _SENSORS].copy()
    test_out = test[:, _SENSORS].copy()
    for cond in np.unique(train[:, _SETTING1]):
        rows = train[:, _SETTING1] == cond
        g = train[rows][:, _SENSORS]
        lo, hi = g.min(axis=0), g.max(axis=0)
        scale = hi - lo
        scale[scale == 0.0] = 1.0
        train_out[rows] = (g - lo) / scale
        trows = test[:, _SETTING1] == cond
        test_out[trows] = (test[trows][:, _SENSORS] - lo) / scale
    return train_out, test_out


def _engines(table: np.ndarray):
    """Each engine's row slice, in the order of its id."""
    _, first, count = np.unique(table[:, _ID], return_index=True,
                                return_counts=True)
    return [slice(s, s + c) for s, c in zip(first, count)]


def _capped_rul(table: np.ndarray, end_cycle: np.ndarray, max_rul: int
                ) -> np.ndarray:
    """``min(end - cycle, max_rul) / max_rul`` per row, float64, where
    ``end_cycle`` holds each engine's last cycle (plus its residual RUL)
    in the order of its id."""
    _, inverse = np.unique(table[:, _ID], return_inverse=True)
    rul = end_cycle[inverse] - table[:, _CYCLE]
    return np.minimum(rul, max_rul) / max_rul


def preprocess_cmapss(data_root: str, data_set: str, max_rul: int = 125,
                      seq_len: int = 50, out_dir: str = "Processed_dataset"):
    """Process one FD00x sub-dataset and write its train/test artifacts."""
    base = os.path.join(data_root, "CMAPSSData")
    train = _read_txt(os.path.join(base, f"train_{data_set}.txt"))
    test = _read_txt(os.path.join(base, f"test_{data_set}.txt"))
    truth = read_table(os.path.join(base, f"RUL_{data_set}.txt"))[:, 0]

    for table in (train, test):
        table[:, _SETTING1] = np.round(table[:, _SETTING1], 1)

    train_engines, test_engines = _engines(train), _engines(test)
    if len(truth) != len(test_engines):
        raise ValueError(f"RUL_{data_set}.txt holds {len(truth)} values for "
                         f"{len(test_engines)} test engines")
    train_end = np.array([train[e, _CYCLE].max() for e in train_engines])
    test_end = np.array([test[e, _CYCLE].max() for e in test_engines])
    train_y = _capped_rul(train, train_end, max_rul)
    test_y = _capped_rul(test, test_end + truth, max_rul)

    train_norm, test_norm = _per_condition_minmax(train, test)

    series = [train_norm[e].astype(np.float32) for e in train_engines]
    labels = [train_y[e].astype(np.float32) for e in train_engines]
    train_x, train_y_arr = window_series(series, labels, seq_len)

    test_x_list, test_y_list = [], []
    for e in test_engines:
        mat = test_norm[e].astype(np.float32)
        lab = test_y[e].astype(np.float32)
        n = mat.shape[0]
        if n < seq_len:
            pad = np.repeat(mat[:1], seq_len - n, axis=0)
            mat = np.concatenate([pad, mat], axis=0)
        test_x_list.append(mat[-seq_len:])
        test_y_list.append(lab[-1])
    test_x = np.stack(test_x_list)
    test_y_arr = np.asarray(test_y_list, dtype=np.float32)[:, None]

    out = os.path.join(out_dir, "CMAPSS", data_set)
    save_processed(out, "train", train_x, train_y_arr, max_rul)
    save_processed(out, "test", test_x, test_y_arr, max_rul)
    return dict(train_x=train_x, train_y=train_y_arr,
                test_x=test_x, test_y=test_y_arr, max_rul=max_rul)
