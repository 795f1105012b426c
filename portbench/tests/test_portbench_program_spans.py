"""The readers of the program's spans and cold-start table
(``serve.stage_share``, ``serve.wait_share``, ``idle_share.forward``,
``setup.first_call_s``, ``setup.first_forward_s``): on hand-built traces,
on one without the program's spans and on a program without the table
(both None, as on a program that records neither), on a CPU run's
profiler trace, and on the card, where the spans must share the device
trace's clock and stay off its activities."""

import dataclasses
import math
import sys
import types

import pytest

from portbench.harness import cell as cells
from portbench.harness import serve
from portbench.harness import trace as tr
from portbench.harness.trace import Span, Trace
from portbench.tests.conftest import tiny_cell

WINDOW_METRICS = ("serve.stage_share", "serve.wait_share",
                  "idle_share.forward")
SETUP_METRICS = ("setup.first_call_s", "setup.first_forward_s")
PROGRAM_SPANS = ("serve.", "hagcn.", "logo.", "logo_bearing.", "kernels.",
                 "train.")


def _read(metric, trace):
    return cells.reader(metric)(cells.Readings({}, None, trace))


def _requests(program_spans: bool) -> Trace:
    """A window of 1000 ns holding two requests. Each: ``serve.call`` of
    100 ns = ``stage_in`` 10 + ``forward`` 60 (the card busy for 45 of
    it) + ``fetch_out`` 20, and 10 ns of the call outside the three."""
    host, device = [], []
    for base in (100, 500):
        host.append(Span(serve.REQUEST_SPAN, base, base + 110))
        if program_spans:
            host += [Span("serve.call", base + 5, base + 105),
                     Span("serve.stage_in", base + 5, base + 15),
                     Span("serve.forward", base + 20, base + 80),
                     Span("hagcn.encoder", base + 25, base + 60),
                     Span("serve.fetch_out", base + 85, base + 105)]
        device += [Span("copy", base + 10, base + 15, kind="memcpy"),
                   Span("lstm_fwd_kernel", base + 30, base + 60),
                   Span("gemm", base + 65, base + 90)]
    host.sort(key=lambda s: (s.start, -s.end))
    return Trace(Span(tr.WINDOW_SPAN, 0, 1000), device,
                 [s for s in device if s.kind == "memcpy"], host)


def test_the_window_readers_on_a_hand_built_trace():
    t = _requests(program_spans=True)
    assert _read("serve.stage_share", t) == pytest.approx(10.0)
    assert _read("serve.wait_share", t) == pytest.approx(20.0)
    # Inside each forward (20-80): busy 30-60 and 65-80 -> 15 ns idle.
    assert _read("idle_share.forward", t) == pytest.approx(3.0)
    assert _read("serve.stage_share.host_paced", t) == pytest.approx(10.0)


def test_the_forward_idle_share_is_0_on_a_card_never_idle_there():
    t = _requests(program_spans=True)
    t.device.append(Span("fill", 0, 1000))
    assert _read("idle_share.forward", t) == 0.0


@pytest.mark.parametrize("metric", WINDOW_METRICS)
def test_without_the_program_spans_a_reader_gives_none(metric):
    assert _read(metric, _requests(program_spans=False)) is None
    assert _read(metric, None) is None
    assert _read(metric + ".host_paced", None) is None


@pytest.mark.parametrize("metric,span", zip(SETUP_METRICS, (
    "serve.call", "serve.forward")))
def test_the_setup_readers_read_the_cold_start_table(metric, span,
                                                     monkeypatch):
    from gnn_rul_tpu_torch import telemetry
    monkeypatch.setattr(telemetry, "_first_s", {span: 1.25})
    assert _read(metric, None) == 1.25
    monkeypatch.setattr(telemetry, "_first_s", {})
    assert _read(metric, None) is None


@pytest.mark.parametrize("metric", SETUP_METRICS)
def test_a_program_without_the_table_gives_none(metric, monkeypatch):
    """As on a program without ``telemetry``: the module cannot be
    imported."""
    package = types.ModuleType("gnn_rul_tpu_torch")
    package.__path__ = []
    monkeypatch.setitem(sys.modules, "gnn_rul_tpu_torch", package)
    monkeypatch.setitem(sys.modules, "gnn_rul_tpu_torch.telemetry", None)
    assert _read(metric, None) is None


def _profiled_window(cell, seed, device, seconds):
    """Set-up, then the closed loop under the harness's window span in a
    profiler of the CPU (and the card, on one): ``(prof, Trace)``."""
    from torch.profiler import ProfilerActivity, profile, record_function

    model, _, pool, sizes, offsets, _ = serve.prepare(cell, seed, device)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        with record_function(tr.WINDOW_SPAN):
            serve.window(model, pool, sizes, offsets, seconds, True)
    return prof, tr.from_profiler(prof)


def _inside(inner, outers):
    """Whether each span of ``inner`` lies inside one of ``outers``."""
    return all(any(o.start <= s.start and s.end <= o.end for o in outers)
               for s in inner)


@pytest.mark.parametrize("workload", ["hagcn-fd001.serve",
                                      "logo_bearing-phm2012.serve",
                                      "fc_stgnn-fd003.serve"])
def test_a_cpu_runs_trace_holds_the_spans_the_readers_read(workload):
    import torch

    _, t = _profiled_window(tiny_cell(workload), 2 ** 33 + 5,
                            torch.device("cpu"), 0.3)
    calls = t.spans("serve.call")
    assert calls and _inside(calls, t.spans(serve.REQUEST_SPAN))
    for c in calls:
        inner = [s for s in t.host if c.start <= s.start and s.end <= c.end
                 and s.name.startswith("serve.") and s is not c]
        assert [s.name for s in inner] == ["serve.stage_in", "serve.forward",
                                           "serve.fetch_out"]
    for metric in ("serve.stage_share", "serve.wait_share"):
        assert 0 < _read(metric, t) < 100
    forward = sum(s.dur for s in t.spans("serve.forward"))
    assert _read("idle_share.forward", t) == pytest.approx(
        100.0 * forward / t.window.dur)   # no device activity on the CPU


@pytest.mark.cuda
@pytest.mark.parametrize("workload,encoder,sizes", [
    ("hagcn-fd001.serve", "hagcn.encoder", [100, 259]),
    ("logo_bearing-phm2012.serve", "logo.encoder", [1139, 1802])])
def test_on_the_card_the_spans_share_the_device_clock(card, workload,
                                                      encoder, sizes):
    """No device activity carries a program span's name; every host
    launch of kernel #4, matched to the kernel by the trace's correlation
    id, lies inside the model's encoder span; every ``serve.call`` inside
    its ``portbench.request``; the window readers read numbers."""
    from torch.autograd import DeviceType

    cell = cells.load(workload)
    cell = dataclasses.replace(cell, traffic={**cell.traffic,
                                              "sizes": sizes})
    prof, t = _profiled_window(cell, 2 ** 31 + 3, card, 1.0)
    assert not [s.name for s in t.device if s.name.startswith(PROGRAM_SPANS)]
    events = list(prof.profiler.kineto_results.events())
    kernels = {e.correlation_id() for e in events
               if e.device_type() == DeviceType.CUDA
               and "lstm_fwd_kernel" in e.name()}
    launches = [Span(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                for e in events if e.device_type() != DeviceType.CUDA
                and e.correlation_id() in kernels
                and "aunch" in e.name()]
    window = [s for s in launches
              if t.window.start <= s.start and s.end <= t.window.end]
    assert window and _inside(window, t.spans(encoder))
    assert _inside(t.spans("serve.call"), t.spans(serve.REQUEST_SPAN))
    for metric in WINDOW_METRICS:
        value = _read(metric, t)
        assert value is not None and math.isfinite(value), metric
