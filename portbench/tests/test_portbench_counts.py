"""The operation and byte counts against counts made by hand."""

import pytest

from portbench.counts import fc_stgnn, gnn, hagcn, logo_bearing, lstm, peaks
from portbench.harness.cell import load


@pytest.mark.parametrize("t,b,h,g", [(3, 2, 4, 1), (14000, 5, 120, 1),
                                     (100, 1000, 30, 5)])
def test_lstm_forward_by_hand(t, b, h, g):
    # Per (step, direction, column): 2 * h * 4h for h @ W_hh, 4h gate
    # additions, 5h activations, 5h cell updates.
    flops = t * 2 * b * (2 * h * 4 * h + 4 * h + 5 * h + 5 * h)
    # xg (T, 2, B, 4H) and W_hh (G, 2, H, 4H) read; ys and cs written.
    nbytes = 4 * (t * 2 * b * 4 * h + g * 2 * h * 4 * h + 2 * t * 2 * b * h)
    assert lstm.forward(t, b, h, g) == (flops, nbytes)


def test_least_time_takes_the_larger_bound():
    assert peaks.least_s(67e12, 0.0) == pytest.approx(1.0)
    assert peaks.least_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert peaks.least_s(67e12, 6.7e12) == pytest.approx(2.0)


def _lstm_by_hand(rows, d, h):
    return 2 * rows * (2 * d * 4 * h + 2 * h * 4 * h)


@pytest.mark.parametrize("n", [1, 7])
def test_hagcn_flops_by_hand(n):
    cfg = load("hagcn-fd001.serve").config
    # Bi-LSTM 10 -> 60 -> 120 -> 60 over n * 14 steps of 5 patches.
    rows = n * 14 * 5
    want = (_lstm_by_hand(rows, 10, 60) + _lstm_by_hand(rows, 60, 120)
            + _lstm_by_hand(rows, 120, 60))
    graph = 2 * 14 * 14 * 60                              # cosine
    for nodes, d in ((14, 60), (10, 64), (5, 64)):
        graph += 2 * nodes * nodes * d + 2 * nodes * (d * 64 + 64 * 64)
        graph += (2 * nodes * nodes * 64 + 2 * nodes * 64 * 64
                  + 2 * nodes * 64 + 2 * nodes * (64 * 32 + 32))
    want += n * 5 * graph + n * 2 * (5 * 192 * 32 + 32)
    assert hagcn.forward_flops(cfg, n) == want


@pytest.mark.parametrize("n", [1, 3])
def test_logo_bearing_flops_by_hand(n):
    cfg = load("logo_bearing-phm2012.serve").config
    # 40 patches of 9 frames of an 8-point DFT to 5 bins, re and im.
    window = 40 * 9 * 2 * (8 * 5 * 2)
    window += 2 * 5 * 5 * 360                             # Pearson
    window += 40 * (2 * 5 * 9 * 18 + 2 * 25 * 18 + 6 * 2 * 125
                    + 2 * 25 * 18 + 2 * 5 * 18 * 27)
    window += 2 * (6000 * 16 + 16 * 8 + 8)
    rows = n * 200
    want = n * window + _lstm_by_hand(rows, 27, 30) \
        + _lstm_by_hand(rows, 30, 60) + _lstm_by_hand(rows, 60, 30)
    assert logo_bearing.forward_flops(cfg, n) == want


def test_lstm_calls_follow_the_widths():
    h = load("hagcn-fd001.serve").config
    assert hagcn.lstm_calls(h, 1000) == [(14000, 5, 60, 1), (14000, 5, 120, 1),
                                         (14000, 5, 60, 1)]
    lb = load("logo_bearing-phm2012.serve").config
    assert logo_bearing.lstm_calls(lb, 74) == [
        (74, 200, 30, 1), (74, 200, 60, 1), (74, 200, 30, 1)]


@pytest.mark.parametrize("b,want", [(100, 540_736), (1000, 5_379_136)])
def test_gnn_forward_bytes_are_the_chip_smoke_bounds(b, want):
    # h and x (B, 28, 16) read once, the (28, 28) mask once, out written.
    flops, nbytes = gnn.forward(b, 28, 16, 16)
    assert nbytes == want
    assert flops == 2 * b * 28 * 28 * (16 + 16)


def test_fc_stgnn_flops_by_hand():
    cfg = load("fc_stgnn-fd003.serve").config
    # Encoder, per (patch, sensor) of 1 sample: Conv1d(1, 8, 2, pad 1) to
    # 2 steps, Conv1d(8, 6, 2, pad 1) to 3, Linear(18, 48).
    patch = 2 * 2 * 8 * 2 + 2 * 3 * 6 * 8 * 2 + 2 * 18 * 48
    want = 50 * 14 * patch
    # 49 + 25 graphs of 28 nodes at 48: mapping, scores and aggregation,
    # theta to 24.
    want += (49 + 25) * (2 * 28 * 48 * 48 + 2 * 28 * 28 * 96
                         + 2 * 28 * 48 * 24)
    # Head: 74 * 14 * 24 = 24,864 -> 48 -> 48 -> 24 -> 1.
    want += 2 * (24_864 * 48 + 48 * 48 + 48 * 24 + 24)
    assert fc_stgnn.forward_flops(cfg, 1) == want
    assert fc_stgnn.forward_flops(cfg, 259) == 259 * want


def test_gnn_calls_follow_the_hparams():
    cfg = load("fc_stgnn-fd003.serve").config
    assert fc_stgnn.gnn_calls(cfg, 259) == [(12_691, 28, 48, 48),
                                           (6_475, 28, 48, 48)]
    assert fc_stgnn.gnn_calls(cfg, 1) == [(49, 28, 48, 48), (25, 28, 48, 48)]
