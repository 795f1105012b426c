"""LOGO_bearing's forward operations per request: every matrix product,
DFT and graph aggregation as 2 m n k (the elementwise work is left out),
from the configuration's widths. A request of ``n`` windows runs the
Bi-LSTM along ``n`` steps with each window's patch-nodes as its columns."""

from __future__ import annotations

from typing import List, Tuple


def _lstm(rows: int, d: int, h: int) -> int:
    return 2 * rows * (2 * d * 4 * h + 2 * h * 4 * h)


def forward_flops(cfg: dict, n: int) -> float:
    hp = cfg["model"]
    t, seg = hp["num_patch"], hp["nperseg"]
    nodes, frames = hp["num_nodes"], hp["input_dim"]
    hid = 3 * hp["hidden_dim"]
    d, d2, d3 = frames, 2 * frames, 3 * frames
    per_window = (
        t * frames * 2 * (seg * nodes * 2)          # the DFT, re and im
        + 2 * nodes * nodes * t * frames            # the Pearson graph
        + t * (2 * nodes * d * d2                   # nonlin_map
               + 2 * nodes * nodes * d2             # the dot graph
               + 6 * 2 * nodes * nodes * nodes      # the fusion gate
               + 2 * nodes * nodes * d2             # MPNN: A X
               + 2 * nodes * d2 * d3)               # MPNN: theta
        + 2 * (nodes * t * hid * 16 + 16 * 8 + 8))  # the MLP head
    rows = n * nodes * t
    total = n * per_window + _lstm(rows, d3, hid) + _lstm(rows, hid, 2 * hid) \
        + _lstm(rows, 2 * hid, hid)
    return float(total)


def lstm_calls(cfg: dict, rows: int) -> List[Tuple[int, int, int, int]]:
    """``(T, B, H, G)`` of each Bi-LSTM recurrence call of a forward over
    ``rows`` windows: T the rows, B the patch-nodes, one group of
    weights."""
    hp = cfg["model"]
    hid = 3 * hp["hidden_dim"]
    b = hp["num_nodes"] * hp["num_patch"]
    return [(rows, b, h, 1) for h in (hid, 2 * hid, hid)]
