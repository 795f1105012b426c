"""Positional encodings (counterpart of ``gnn_rul_tpu/ops/encoding.py``)."""

from __future__ import annotations

import numpy as np
import torch


def sinusoidal_encoding(length: int, d_model: int, base: float = 100.0,
                        dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """``(length, d_model)`` sinusoidal table, built in float64 with numpy.

    NOTE the reference uses base **100.0** (``math.log(100.0)``), not the
    usual 10000.0 — models/FC_STGNN/Model_Base.py:121-124.
    """
    position = np.arange(length)[:, None].astype(np.float64)
    div_term = np.exp(np.arange(0, d_model, 2).astype(np.float64)
                      * -(np.log(base) / d_model))
    pe = np.zeros((length, d_model))
    pe[:, 0::2] = np.sin(position * div_term)
    # torch slice pe[:, 1::2] has floor(d/2) cols; cos term count must match.
    pe[:, 1::2] = np.cos(position * div_term[: pe[:, 1::2].shape[1]])
    return torch.as_tensor(pe, dtype=dtype)
