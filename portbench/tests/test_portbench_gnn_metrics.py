"""The dot-graph forward's readers (``gnn_fwd_roofline``,
``serve.gnn_share``) on hand-built traces: only kernel #2's two plans
count, never the backward's, the graph attention's or the LSTM's kernels;
a configuration without dot-graph calls, or a window without its
kernels, gives None."""

import pytest

from portbench.counts import gnn, peaks
from portbench.harness import cell as cells
from portbench.harness import trace as tr
from portbench.harness.trace import Span, Trace

NAMES = {
    "void (anonymous namespace)::fwd_graph_kernel<2>(float const*)": 300,
    "void (anonymous namespace)::fwd_rows_kernel<float>(float const*)": 100,
    "void (anonymous namespace)::bwd_graph_kernel<float>(float*)": 1000,
    "void (anonymous namespace)::bwd_rows_kernel(float*)": 1000,
    "void (anonymous namespace)::bwd_cols_kernel(float*)": 1000,
    "void (anonymous namespace)::fused_gat_kernel<float>(float*)": 1000,
    "void (anonymous namespace)::lstm_fwd_kernel_ring<float, false>()": 1000,
}


def _trace(names) -> Trace:
    device, t = [], 0
    for name in names:
        device.append(Span(name, t, t + NAMES[name], kind="kernel"))
        t += NAMES[name] + 100
    return Trace(Span(tr.WINDOW_SPAN, 0, 10 ** 6), device)


def _read(metric, trace, workload="fc_stgnn-fd003.serve", requests=(100,)):
    cell = cells.load(workload)
    return cells.reader(metric)(cells.Readings(
        cell.config, cell.counts, trace, {"request": list(requests)}))


def test_only_kernel_2_counts():
    trace = _trace(NAMES)
    busy = sum(NAMES.values())
    assert _read("serve.gnn_share", trace) == pytest.approx(100 * 400 / busy)
    cfg = cells.load("fc_stgnn-fd003.serve").config
    least = sum(peaks.least_s(*gnn.forward(*c))
                for c in cells.load("fc_stgnn-fd003.serve").counts
                .gnn_calls(cfg, 100))
    assert _read("gnn_fwd_roofline", trace) == pytest.approx(
        100 * least / 400e-9)


@pytest.mark.parametrize("metric", ["gnn_fwd_roofline", "serve.gnn_share"])
def test_nothing_to_read_gives_none(metric):
    others = [n for n in NAMES if "fwd_graph" not in n and "fwd_rows" not in n]
    assert _read(metric, _trace(others)) is None
    assert _read(metric, None) is None


def test_a_configuration_without_dot_graph_calls_gives_none():
    assert _read("gnn_fwd_roofline", _trace(NAMES),
                 workload="hagcn-fd001.serve") is None
