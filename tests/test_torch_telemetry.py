"""The port's spans and cold-start table (``gnn_rul_tpu_torch/telemetry.py``)
on the CPU: a served request's spans in order and the model's inside its
forward, under ``torch.profiler``; nothing entered without one; each
``first=True`` span timed once; the kernel loads and nvcc runs counted;
the engines' step and evaluation spans, inside ``torch.func.vmap`` too; and
an artifact exported with the spans in the code, under a profiler, holding
none of them and serving the live model's answers."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from gnn_rul_tpu_torch import export, telemetry
from gnn_rul_tpu_torch.ops.kernels import build, fused_lstm
from gnn_rul_tpu_torch.train.algorithms import get_algorithm_spec
from gnn_rul_tpu_torch.train.engine import Engine
from gnn_rul_tpu_torch.train.vectorized import VectorizedEngine

torch.set_num_threads(1)

# method -> (dataset, dataset_id, window shape, the model's spans in order)
SERVED = {
    "HAGCN": ("CMAPSS", "FD001", (14, 50),
              ["hagcn.encoder", "hagcn.graph", "hagcn.stage1",
               "hagcn.stage2", "hagcn.stage3", "hagcn.head"]),
    "LOGO_bearing": ("PHM2012", "Condition_1", (1, 2560),
                     ["logo_bearing.front_end", "logo.graphs", "logo.mpnn",
                      "logo.encoder", "logo.head"]),
}
SERVE_SPANS = ["serve.stage_in", "serve.forward", "serve.fetch_out"]
TRAIN_PARAMS = {"num_epochs": 1, "batch_size": 4, "learning_rate": 1e-3,
                "weight_decay": 1e-4, "alpha": 100, "lambda": 0.1,
                "theta": 0.001}


def _served(method, rows=3):
    dataset, sub_id, shape, _ = SERVED[method]
    torch.manual_seed(0)
    model = export.build_model(method, dataset, sub_id)
    served = export.serving_model(method, dataset, sub_id,
                                  model.state_dict(), device="cpu")
    x = np.random.default_rng(1).uniform(size=(rows, *shape)).astype(
        np.float32)
    return served, x


def _spans(prof, prefixes=("serve.", "hagcn.", "logo.", "logo_bearing.",
                           "kernels.", "train.")):
    """The port's spans in a stopped profiler, ``(name, start, end)`` by
    start."""
    return sorted(((e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
                   for e in prof.profiler.kineto_results.events()
                   if e.name().startswith(prefixes)), key=lambda s: s[1])


def _inside(spans, outer):
    return [s for s in spans if outer[1] <= s[1] and s[2] <= outer[2]
            and s is not outer]


@pytest.mark.parametrize("method", list(SERVED))
def test_a_served_call_records_its_spans_in_order(method):
    served, x = _served(method)
    served(x)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        served(x)
    spans = _spans(prof)
    calls = [s for s in spans if s[0] == "serve.call"]
    assert len(calls) == 1
    inner = _inside(spans, calls[0])
    assert [s[0] for s in inner if s[0].startswith("serve.")] == SERVE_SPANS
    stage_in, forward, fetch_out = (
        next(s for s in inner if s[0] == name) for name in SERVE_SPANS)
    assert stage_in[2] <= forward[1] and forward[2] <= fetch_out[1]
    assert [s[0] for s in _inside(spans, forward)] == SERVED[method][3]
    assert [s[0] for s in spans if not s[0].startswith("serve.")] == \
        SERVED[method][3]


def test_without_a_profiler_no_span_enters_record_function(monkeypatch):
    entered = []
    real = telemetry._profiler.record_function

    def counting(name, *args):
        entered.append(name)
        return real(name, *args)

    monkeypatch.setattr(telemetry._profiler, "record_function", counting)
    served, x = _served("HAGCN")
    served(x)
    served(x)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        served(x)
    assert entered[:2] == ["serve.call", "serve.stage_in"]
    assert set(SERVED["HAGCN"][3]) <= set(entered)


def test_cold_start_holds_each_first_span_once():
    served, x = _served("LOGO_bearing")
    served(x)
    first = telemetry.cold_start()
    assert {"serve.call", *SERVE_SPANS} <= set(first["first_s"])
    call_s = first["first_s"]["serve.call"]
    assert call_s >= first["first_s"]["serve.forward"] > 0
    served(x)
    with profile(activities=[ProfilerActivity.CPU]):
        served(x)
    assert telemetry.cold_start() == first
    assert not set(first["first_s"]) & {"hagcn.encoder", "logo.encoder"}


def test_a_failed_first_occurrence_is_not_timed():
    name = "test.failing_first"
    with pytest.raises(ValueError):
        with telemetry.span(name, first=True):
            raise ValueError("refused")
    assert name not in telemetry.cold_start()["first_s"]
    with telemetry.span(name, first=True):
        pass
    assert telemetry.cold_start()["first_s"][name] >= 0


def test_a_kernel_load_is_timed_once_and_only_when_it_loads(monkeypatch):
    opened = []
    wrapper = fused_lstm.FusedLstmRecurrence()

    def fake_open():
        opened.append(1)
        wrapper._fwd = wrapper._bwd = object()

    monkeypatch.setattr(wrapper, "_open", fake_open)
    monkeypatch.setattr(telemetry, "_first_s", {})
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        wrapper.load()
        wrapper.load()
    assert opened == [1]
    assert list(telemetry.cold_start()["first_s"]) == \
        ["kernels.load.fused_lstm"]
    assert [s[0] for s in _spans(prof)] == ["kernels.load.fused_lstm"]


def test_nvcc_runs_are_counted(tmp_path, monkeypatch):
    """Every source not yet in ``build/`` is one nvcc run (here a stand-in
    that writes its output); a second build finds them all and runs
    none."""
    class FakeNvcc:
        def __init__(self, cmd, **kwargs):
            open(cmd[cmd.index("-o") + 1], "wb").close()
            self.returncode = 0

        def communicate(self):
            return "", None

    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "Popen", FakeNvcc)
    monkeypatch.setattr(telemetry, "_counts", {})
    sources = len(list(build.CSRC.glob("*.cu")))
    assert len(build.build_libraries()) == sources
    assert telemetry.cold_start()["counts"] == {"kernels.compiled": sources}
    build.build_libraries()
    assert telemetry.cold_start()["counts"] == {"kernels.compiled": sources}


@pytest.mark.parametrize("vectorized", [False, True])
def test_the_engines_record_their_step_and_evaluation(vectorized):
    """LOGO's steps and evaluation, the model's spans inside each; under
    ``torch.func.vmap`` in the vectorized engine."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(4, 14, 50)).astype(np.float32)
    y = rng.uniform(size=(4, 1)).astype(np.float32)
    spec = get_algorithm_spec("LOGO")

    def make():
        return export.build_model("LOGO", "CMAPSS", "FD001")

    engine = (VectorizedEngine(make, spec, TRAIN_PARAMS, [0, 1],
                               device="cpu") if vectorized
              else Engine(make(), spec, TRAIN_PARAMS, device="cpu"))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        engine.run_epoch(x, y, 1, shuffle=False)
        engine.evaluate(x)
    spans = _spans(prof)
    steps = [s for s in spans if s[0] == "train.step"]
    evals = [s for s in spans if s[0] == "train.eval"]
    assert len(steps) == 1 and len(evals) == 1
    for outer in (steps[0], evals[0]):
        assert "logo.encoder" in [s[0] for s in _inside(spans, outer)]


def test_an_artifact_exported_under_a_profiler_holds_no_span(tmp_path):
    """HAGCN exported with a profiler recording: no profiler call in the
    program, and the loaded artifact answers as the live model does."""
    served, x = _served("HAGCN", rows=5)
    with profile(activities=[ProfilerActivity.CPU]):
        meta, program = export.export_serving(
            "HAGCN", "CMAPSS", "FD001", served.model.state_dict(),
            device="cpu")
    assert not [n for n in program.graph.nodes
                if "profiler" in str(n.target)]
    path = export.save_artifact(str(tmp_path / "hagcn.pt2"), meta, program)
    art = export.load_artifact(path, device="cpu")
    np.testing.assert_allclose(art(x), served(x), atol=1e-5, rtol=1e-5)
