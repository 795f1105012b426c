"""Operations and bytes of the Bi-LSTM recurrence's forward kernel (#4,
``csrc/fused_lstm.cu``), per call of the registered operator
``gnn_rul_tpu_torch::lstm_recurrence`` on ``xg (T, 2, B, 4H)`` and
``w_hh ([G,] 2, H, 4H)``, as ``chip_smoke.py::_lstm_bound_ms`` counts them.

Per (step, direction, column): xg and w_hh read once and ys and the c
trajectory written once; 8H^2 for the recurrent product, 4H gate
additions, 5H activations and 5H for the cell.
"""

from __future__ import annotations

from typing import Tuple


def forward(t: int, b: int, h: int, groups: int = 1) -> Tuple[float, float]:
    """``(flops, bytes)`` of one float32 forward call."""
    rows = t * 2 * b
    nbytes = 4 * (rows * (4 * h + 2 * h) + groups * 2 * h * 4 * h)
    flops = rows * (8 * h * h + 14 * h)
    return float(flops), float(nbytes)
