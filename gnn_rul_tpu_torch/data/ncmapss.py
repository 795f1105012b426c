"""N-CMAPSS (DS02-006) offline preprocessing (counterpart of
``gnn_rul_tpu/data/ncmapss.py``; numpy alone, and ``h5py`` imported in the
function that reads the file).

Reproduces the reference contract (Data_Process/Data_read_NCMAPSS.py:18-267):
  - read W, X_s, X_v[:, :2] (T40, P30), Y, A from the h5 file
  - subsample every ``subsampling``-th row (100)
  - train units {2,5,10,16,18,20}, test units {11,14,15}
  - MinMax(-1, 1) fit on the train split
  - sliding windows length 50 stride 1 per unit; label = window-end RUL
  - train labels normalized by max(train window labels); test kept as a dict
    keyed by float unit id, with per-unit labels / the SAME train max

Channel ORDER matters: the reference normalizes
``df.columns.difference(['RUL','unit'])`` which pandas sorts
alphabetically — reproduced here.
"""

from __future__ import annotations

import os

import numpy as np

from .io import save_processed

W_VARS = ["alt", "Mach", "TRA", "T2"]
XS_VARS = ["T24", "T30", "T48", "T50", "P15", "P2", "P21", "P24", "Ps30",
           "P40", "P50", "Nf", "Nc", "Wf"]
XV_VARS = ["T40", "P30"]
TRAIN_UNITS = [2.0, 5.0, 10.0, 16.0, 18.0, 20.0]
TEST_UNITS = [11.0, 14.0, 15.0]

# pandas Index.difference sorts lexicographically.
CHANNELS = sorted(W_VARS + XS_VARS + XV_VARS)


def _windows(mat: np.ndarray, labels: np.ndarray, seq_len: int, stride: int):
    n = (mat.shape[0] - seq_len) // stride + 1
    xs = np.stack([mat[i * stride:i * stride + seq_len] for i in range(n)])
    ys = np.stack([labels[i * stride + seq_len - 1] for i in range(n)])
    return xs.astype(np.float32), ys.astype(np.float32)


def preprocess_ncmapss(data_root: str, window_size: int = 50, stride: int = 1,
                       subsampling: int = 100,
                       out_dir: str = "Processed_dataset"):
    import h5py
    path = os.path.join(data_root, "N-CMAPSS", "N-CMAPSS_DS02-006.h5")
    with h5py.File(path, "r") as hdf:
        w = np.concatenate([hdf["W_dev"][:], hdf["W_test"][:]], axis=0)
        xs = np.concatenate([hdf["X_s_dev"][:], hdf["X_s_test"][:]], axis=0)
        xv = np.concatenate([hdf["X_v_dev"][:, :2], hdf["X_v_test"][:, :2]],
                            axis=0)
        y = np.concatenate([hdf["Y_dev"][:], hdf["Y_test"][:]], axis=0)
        a = np.concatenate([hdf["A_dev"][:], hdf["A_test"][:]], axis=0)

    unit = a[:, 0]
    col_names = W_VARS + XS_VARS + XV_VARS
    data = np.concatenate([w, xs, xv], axis=1)
    order = [col_names.index(c) for c in CHANNELS]
    data = data[:, order]

    # subsample every k-th row
    data = data[::subsampling]
    y = y[::subsampling].reshape(-1)
    unit = unit[::subsampling]

    train_mask = np.isin(unit, TRAIN_UNITS)
    lo = data[train_mask].min(axis=0)
    hi = data[train_mask].max(axis=0)
    scale = np.where(hi - lo == 0, 1.0, hi - lo)
    # MinMax to (-1, 1)
    data = (data - lo) / scale * 2.0 - 1.0

    train_x_list, train_y_list = [], []
    for u in TRAIN_UNITS:
        m = unit == u
        xw, yw = _windows(data[m], y[m], window_size, stride)
        train_x_list.append(xw)
        train_y_list.append(yw)
    train_x = np.concatenate(train_x_list, axis=0)
    train_y = np.concatenate(train_y_list, axis=0)
    max_rul = float(train_y.max())
    train_y = (train_y / max_rul)[:, None].astype(np.float32)

    test_x, test_y, max_ruls = {}, {}, {}
    for u in TEST_UNITS:
        m = unit == u
        xw, yw = _windows(data[m], y[m], window_size, stride)
        test_x[u] = xw
        test_y[u] = (yw / max_rul)[:, None].astype(np.float32)
        max_ruls[u] = max_rul

    out = os.path.join(out_dir, "NCMAPSS")
    save_processed(out, "train", train_x, train_y, max_ruls)
    save_processed(out, "test", test_x, test_y, max_ruls)
    return dict(train_x=train_x, train_y=train_y, test_x=test_x,
                test_y=test_y, max_rul=max_ruls)
