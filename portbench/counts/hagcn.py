"""HAGCN's forward operations per request: every matrix product and
graph aggregation as 2 m n k (the elementwise work is left out), from the
configuration's widths. A request of ``n`` windows runs the Bi-LSTM along
``n * sensors`` steps with the patches as its columns, then the graph
stages window by window."""

from __future__ import annotations

from typing import List, Tuple


def _lstm(rows: int, d: int, h: int) -> int:
    """Both directions of one layer over ``rows`` (step, column) pairs:
    the input projection and the recurrent product."""
    return 2 * rows * (2 * d * 4 * h + 2 * h * 4 * h)


def _gin(nodes: int, d: int, h: int) -> int:
    return 2 * nodes * nodes * d + 2 * nodes * (d * h + h * h)


def _sagpool(nodes: int, h: int) -> int:
    return (2 * nodes * nodes * h + 2 * nodes * h * h + 2 * nodes * h
            + 2 * nodes * (h * (h // 2) + h // 2))


def forward_flops(cfg: dict, n: int) -> float:
    hp = cfg["model"]
    sensors = cfg["input"]["channels"]
    p, t = hp["patch_size"], hp["num_patch"]
    e, h, o = hp["encoder_hidden_dim"], hp["hidden_dim"], hp["output_dim"]
    rows = n * sensors * t
    total = _lstm(rows, p, e) + _lstm(rows, e, 2 * e) + _lstm(rows, 2 * e, e)
    graphs = n * t
    nodes1, nodes2, nodes3 = sensors, 10, 5   # SAGPool keeps 10, 5, then 1
    per_graph = (2 * sensors * sensors * e            # cosine graph
                 + _gin(nodes1, e, h) + _sagpool(nodes1, h)
                 + _gin(nodes2, h, h) + _sagpool(nodes2, h)
                 + _gin(nodes3, h, h) + _sagpool(nodes3, h))
    total += graphs * per_graph
    total += n * 2 * (t * 3 * h * o + o)              # the MLP head
    return float(total)


def lstm_calls(cfg: dict, rows: int) -> List[Tuple[int, int, int, int]]:
    """``(T, B, H, G)`` of each Bi-LSTM recurrence call of a forward over
    ``rows`` windows: T the rows times the sensors, B the patches, one
    group of weights."""
    hp = cfg["model"]
    e, t = hp["encoder_hidden_dim"], rows * cfg["input"]["channels"]
    return [(t, hp["num_patch"], h, 1) for h in (e, 2 * e, e)]
