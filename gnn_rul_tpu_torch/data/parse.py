"""Text-table parsing and window extraction for the offline preprocessors
(the numpy paths of ``gnn_rul_tpu/native/__init__.py``, without its C++
library or ctypes).

Every table parses through ``np.loadtxt`` after ``,`` and ``;`` are
rewritten to spaces, so spaces, tabs, commas and semicolons all separate
values, and a line's trailing blanks make no column. Values parse as
float64 and are correctly rounded (``np.loadtxt`` rounds as ``float()``
does), so a file gives the same doubles as the JAX package's parsers.
"""

from __future__ import annotations

from typing import List

import numpy as np

_SEPARATORS = str.maketrans({",": " ", ";": " "})


def _lines(path: str) -> List[str]:
    with open(path, "r") as f:
        return f.read().translate(_SEPARATORS).splitlines()


def read_table(path: str, skip_rows: int = 0) -> np.ndarray:
    """A numeric text file -> ``(rows, cols)`` float64."""
    return np.loadtxt(_lines(path)[skip_rows:], dtype=np.float64, ndmin=2)


def read_header(path: str) -> List[str]:
    """The names on a file's first line, split as the values are."""
    with open(path, "r") as f:
        return f.readline().translate(_SEPARATORS).split()


def sliding_windows(data: np.ndarray, win: int) -> np.ndarray:
    """Every stride-1 window of length ``win`` of ``(n, d)`` ->
    ``(n - win + 1, win, d)`` float32, a contiguous copy."""
    data = np.ascontiguousarray(data, np.float32)
    n = data.shape[0]
    if n < win:
        raise ValueError(f"series length {n} < window {win}")
    return data[np.arange(n - win + 1)[:, None] + np.arange(win)]


def window_series(series: List[np.ndarray], labels: List[np.ndarray],
                  win: int):
    """Every stride-1 window of each series, labelled with the label at the
    window's last row; a series shorter than ``win`` gives none (the
    reference's training-set rule). Returns ``x (W, win, d)`` and ``y (W,
    1)``, float32."""
    if len(series) != len(labels):
        raise ValueError(f"{len(series)} series, {len(labels)} label arrays")
    d = series[0].shape[1]
    xs, ys = [], []
    for s, lab in zip(series, labels):
        if s.shape[0] < win:
            continue
        xs.append(sliding_windows(s, win))
        ys.append(np.asarray(lab, np.float32)[win - 1:])
    x = np.concatenate(xs) if xs else np.empty((0, win, d), np.float32)
    y = np.concatenate(ys) if ys else np.empty((0,), np.float32)
    return x, y.reshape(-1, 1)
