"""The port's serving artifacts (gnn_rul_tpu_torch.export: export_serving,
save_artifact, load_artifact, main) against the JAX package's exported
artifact and the port's live serving model, on the CPU, for FC_STGNN, LOGO,
STAGNN and STFA on CMAPSS/FD001 at the hparam bank's widths: the same
seeded numpy weights (carried by from_jax_variables), the same seeded
inputs. Also the three registered operators the artifacts call
(torch.library.opcheck), their counts in each exported graph, and the
wrappers' checks on a symbolic batch."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import export as jexport
from torch.export import Dim

from gnn_rul_tpu.configs import hparams
from gnn_rul_tpu.export import ServingModel as JaxServingModel
from gnn_rul_tpu.export import export_serving as jax_export_serving
from gnn_rul_tpu.train.algorithms import get_algorithm_spec
from gnn_rul_tpu_torch import export
from gnn_rul_tpu_torch.compat import from_jax_variables
from gnn_rul_tpu_torch.ops.kernels import fused_gat, fused_gnn, fused_lstm
from gnn_rul_tpu_torch.ops.kernels.fused_gat import fused_gat as gat
from gnn_rul_tpu_torch.ops.kernels.fused_gnn import fused_dot_graph_spmm
from gnn_rul_tpu_torch.ops.kernels.fused_lstm import lstm_recurrence
from gnn_rul_tpu_torch.train.checkpoint import save_checkpoint

from test_torch_attention import _min_abs_cov

torch.set_num_threads(1)

JAX_ATOL, JAX_RTOL = 2e-4, 1e-4   # tests/test_parity_fc_stgnn.py:69
LIVE_ATOL, LIVE_RTOL = 1e-5, 1e-5  # tests/test_export.py:52
# Each method's operator and its calls a forward: 2 dot-graph scales, 3
# Bi-LSTM layers, 2 GAT layers x 3 heads, 10 heads.
OPS = {"FC_STGNN": ("fused_dot_graph_spmm", 2),
       "LOGO": ("lstm_recurrence", 3),
       "STAGNN": ("fused_gat", 6),
       "STFA": ("fused_gat", 10)}
METHODS = tuple(OPS)
ROWS = (1, 37, 100)
# STAGNN's two temporal encoders each reweight by a softmax over the 64
# positions, close to 1/64: at unit gain its answers vary by 5e-5 across
# windows, below the tolerances here; at 3 by 0.4.
GAIN = {"STAGNN": 3.0}


def seeded_variables(method, seed=0):
    """JAX variables of ``method``/FD001 from seeded numpy draws: weights
    at ``GAIN``/sqrt(fan-in), BN means and scales away from 0 and 1."""
    model = get_algorithm_spec(method).model_cls(
        **hparams.model_hparams("CMAPSS", "FD001", method))
    shapes = jax.eval_shape(lambda: model.init(
        {"params": jax.random.PRNGKey(0), "dropout": jax.random.PRNGKey(1)},
        jnp.zeros((2, 14, 50), jnp.float32), train=False))
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "mean":
            a = rng.normal(0.0, 0.5, shape)
        elif name in ("var", "scale"):
            a = rng.uniform(0.5, 2.0, shape)
        elif name == "bias" or len(shape) < 2:
            a = rng.normal(0.0, 0.1, shape)
        else:
            a = (rng.normal(0.0, GAIN.get(method, 1.0), shape)
                 / np.sqrt(np.prod(shape[:-1])))
        return a.astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, dict(shapes))


def _x(rows, seed):
    """Seeded windows whose covariances all lie more than 1e-5 from 0:
    STAGNN's graph is ``cov > 0``, a step function, and an entry within
    rounding of 0 can flip between the two packages' summation orders. The
    first of the seeds ``seed``, ``seed + 1000``, ... that gives such
    windows."""
    while True:
        x = np.random.default_rng(seed).normal(size=(rows, 14, 50)).astype(
            np.float32)
        if _min_abs_cov(x) > 1e-5:
            return x
        seed += 1000


def _jax_artifact(method, variables, batch_size):
    meta, blob = jax_export_serving(
        method, "CMAPSS", "FD001", variables, batch_size=batch_size,
        platforms=("cpu",))
    return JaxServingModel(meta, jexport.deserialize(bytearray(blob)))


def _round_trip(tmp_path, method, state_dict, **kw):
    meta, program = export.export_serving(method, "CMAPSS", "FD001",
                                          state_dict, device="cpu", **kw)
    path = export.save_artifact(str(tmp_path / f"{method}.pt2"), meta,
                                program)
    return export.load_artifact(path, device="cpu")


@pytest.fixture(scope="module", params=METHODS)
def case(request, tmp_path_factory):
    """Per method: its JAX variables, its state_dict, the symbolic-batch
    artifact after save and load, and the live port model."""
    method = request.param
    variables = seeded_variables(method)
    sd = from_jax_variables(method, variables)
    tmp = tmp_path_factory.mktemp(method)
    return {"method": method, "variables": variables, "state_dict": sd,
            "artifact": _round_trip(tmp, method, sd),
            "live": export.serving_model(method, "CMAPSS", "FD001", sd,
                                         device="cpu")}


def _small_op_cases():
    rng = np.random.default_rng(0)

    def t(*shape, scale=1.0):
        return torch.from_numpy((rng.normal(size=shape) * scale).astype(
            np.float32)).requires_grad_()

    adj = torch.from_numpy((rng.random((3, 5, 5)) > 0.5).astype(np.float32))
    return {
        "fused_dot_graph_spmm": (t(3, 5, 4), t(3, 5, 6),
                                 torch.rand(5, 5).requires_grad_()),
        "lstm_recurrence": (t(4, 2, 3, 8), t(2, 2, 8, scale=0.3)),
        "fused_gat": (t(3, 5, 4), t(3, 5), t(3, 5), adj.requires_grad_(),
                      torch.tensor(0.1, requires_grad=True), 0.2),
    }


@pytest.mark.parametrize("name", ["fused_dot_graph_spmm", "lstm_recurrence",
                                  "fused_gat"])
def test_operator_passes_opcheck(name):
    """Schema, autograd registration, the fake implementation against the
    CPU one, and a trace with symbolic shapes."""
    op = getattr(torch.ops.gnn_rul_tpu_torch, name).default
    torch.library.opcheck(op, _small_op_cases()[name])


@pytest.mark.parametrize("rows", ROWS)
def test_symbolic_artifact_matches_jax_artifact(case, rows):
    x = _x(rows, seed=rows)
    want = _jax_artifact(case["method"], case["variables"], None)(x)
    got = case["artifact"](x)
    assert got.shape == (rows,) and got.dtype == np.float32
    assert np.isfinite(got).all()
    assert rows == 1 or np.ptp(want) > 1e-3  # the answers are not constant
    np.testing.assert_allclose(got, want, atol=JAX_ATOL, rtol=JAX_RTOL)


def test_symbolic_artifact_matches_live_model(case):
    art = case["artifact"]
    assert art.meta["input_shape"] == [None, 14, 50]
    assert art.meta["format"] == export.ARTIFACT_FORMAT
    for rows in ROWS:
        x = _x(rows, seed=rows + 1)
        np.testing.assert_allclose(art(x), case["live"](x), atol=LIVE_ATOL,
                                   rtol=LIVE_RTOL)


@pytest.mark.parametrize("rows", [6, 4])
def test_fixed_batch_pads_and_trims(case, tmp_path, rows):
    """A fixed batch of 4 on 6 rows (pad the second forward with row 4,
    trim) and on 4, against the JAX fixed-batch artifact, whose padding
    is the same (LOGO's answers depend on the padding rows), and the live
    model at the same batch."""
    method, sd = case["method"], case["state_dict"]
    art = _round_trip(tmp_path, method, sd, batch_size=4)
    assert art.meta["input_shape"] == [4, 14, 50]
    x = _x(rows, seed=rows + 20)
    got = art(x)
    assert got.shape == (rows,)
    np.testing.assert_allclose(
        got, _jax_artifact(method, case["variables"], 4)(x), atol=JAX_ATOL,
        rtol=JAX_RTOL)
    live = export.serving_model(method, "CMAPSS", "FD001", sd, batch_size=4,
                                device="cpu")
    np.testing.assert_allclose(got, live(x), atol=LIVE_ATOL, rtol=LIVE_RTOL)


def test_exported_graph_calls_the_operator(case):
    """Each forward kernel is one opaque node a call; nothing of a
    wrapper's plain path (an einsum, the LSTM's time loop) is traced into
    the program, and the batch stays symbolic."""
    name, calls = OPS[case["method"]]
    program = case["artifact"].program
    targets = [n.target for n in program.graph.nodes
               if n.op == "call_function"]
    op = getattr(torch.ops.gnn_rul_tpu_torch, name).default
    assert targets.count(op) == calls
    assert not [t for t in targets
                if str(t).startswith("gnn_rul_tpu_torch.") and t != op]
    traced_from = [n.meta.get("stack_trace") or "" for n in program.graph.nodes]
    assert any("models" in s for s in traced_from)
    assert not [s for s in traced_from if "ops/kernels" in s]
    (batch,) = program.range_constraints.values()
    assert str(batch) == "VR[1, int_oo]"


class _Calls(torch.nn.Module):
    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def _gat_call(adj_rank):
    adj2 = (torch.rand(5, 5) > 0.5).float()

    def fn(x):  # x (B, 5, 4): the batch is the number of graphs
        f = x.sum(-1)
        adj = adj2 if adj_rank == 2 else adj2.expand(x.shape[0], 5, 5) + 0
        return gat(x, f, f * 0.5, adj, torch.tensor(0.1), 0.2)
    return fn, (3, 5, 4)


GUARD_CASES = {
    # fused_gat.py's adjacency check once compared a (B, N, N) shape with
    # (N, N) element by element, adding the guard B != N.
    "fused_gat_per_graph_adj": lambda: _gat_call(3),
    "fused_gat_shared_adj": lambda: _gat_call(2),
    # fused_lstm.py's check once took min(T, B, H), comparing a symbolic
    # T (an exported LOGO's batch) with B and H.
    "lstm_recurrence_symbolic_t": lambda: (
        lambda x: lstm_recurrence(x, torch.full((2, 5, 20), 0.1))[0],
        (6, 2, 5, 20)),
    "fused_dot_graph_spmm": lambda: (
        lambda x: fused_dot_graph_spmm(x, x * 2, torch.ones(5, 5)),
        (3, 5, 4)),
}


@pytest.mark.parametrize("name", list(GUARD_CASES))
def test_wrapper_checks_leave_the_batch_symbolic(name):
    """Each wrapper's checks run on a symbolic batch (or T) at export and
    add no guard: the export succeeds over [1, inf) and the program
    serves a batch of 1 as the wrapper does."""
    fn, shape = GUARD_CASES[name]()
    torch.manual_seed(0)
    x = torch.rand(shape)
    with torch.no_grad():
        program = torch.export.export(_Calls(fn), (x,),
                                      dynamic_shapes=({0: Dim("batch",
                                                              min=1)},))
    (batch,) = program.range_constraints.values()
    assert str(batch) == "VR[1, int_oo]"
    one = x[:1]
    with torch.no_grad():
        torch.testing.assert_close(program.module()(one), fn(one))


def _checkpoint(tmp_path, method, state_dict, prefix):
    model = export.build_model(method, "CMAPSS", "FD001")
    model.load_state_dict(state_dict)
    path = str(tmp_path / "checkpoint.pt")
    save_checkpoint(path, model, torch.optim.Adam(model.parameters()),
                    epoch=1, run_id=0, train_params={"batch_size": 100},
                    hparams=hparams.model_hparams("CMAPSS", "FD001", method))
    if prefix:
        payload = torch.load(path, weights_only=True)
        payload["model_dict"] = {f"model.{k}": v
                                 for k, v in payload["model_dict"].items()}
        torch.save(payload, path)
    return path


@pytest.mark.parametrize("prefix", [False, True])
def test_cli_exports_a_checkpoint(tmp_path, capsys, prefix):
    """``python -m gnn_rul_tpu_torch.export`` from a port checkpoint.pt,
    its model_dict bare or under the algorithm's ``model.`` prefix."""
    variables = seeded_variables("FC_STGNN", seed=4)
    sd = from_jax_variables("FC_STGNN", variables)
    ckpt = _checkpoint(tmp_path, "FC_STGNN", sd, prefix)
    out = str(tmp_path / "m.pt2")
    export.main(["--checkpoint", ckpt, "--GNN_method", "FC_STGNN",
                 "--dataset", "CMAPSS", "--dataset_id", "FD001", "--out", out,
                 "--max_rul", "125", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line["artifact"] == out and line["bytes"] == os.path.getsize(out)
    assert line["max_rul"] == 125.0 and line["input_shape"] == [None, 14, 50]
    assert not os.path.exists(out + ".tmp")
    art = export.load_artifact(out, device="cpu")
    x = _x(7, seed=9)
    np.testing.assert_allclose(
        art(x), export.serving_model("FC_STGNN", "CMAPSS", "FD001", sd,
                                     device="cpu")(x),
        atol=LIVE_ATOL, rtol=LIVE_RTOL)


def test_bf16_raises_naming_roadmap():
    """bf16 export is ported (it raised until then, naming ROADMAP): its
    program takes and returns fp32 and serves as the live bf16 model; a
    precision other than fp32 or bf16 raises."""
    sd = from_jax_variables("FC_STGNN", seeded_variables("FC_STGNN"))
    meta, program = export.export_serving("FC_STGNN", "CMAPSS", "FD001", sd,
                                          precision="bf16", device="cpu")
    assert meta["precision"] == "bf16"
    x = _x(5, seed=4)
    got = program.module()(torch.from_numpy(x)).detach().numpy()
    live = export.serving_model("FC_STGNN", "CMAPSS", "FD001", sd,
                                precision="bf16", device="cpu")
    assert got.dtype == np.float32 and live(x).dtype == np.float32
    np.testing.assert_array_equal(got, live(x))
    with pytest.raises(ValueError, match="precision"):
        export.export_serving("FC_STGNN", "CMAPSS", "FD001", sd,
                              precision="fp16", device="cpu")


def test_load_rejects_a_foreign_file(tmp_path):
    """Another program's torch.export archive, the JAX package's artifact
    and a file that is no archive."""
    other = torch.export.export(_Calls(lambda x: x * 2), (torch.ones(2),))
    torch.export.save(other, str(tmp_path / "other.pt2"))
    variables = seeded_variables("FC_STGNN")
    meta, blob = jax_export_serving("FC_STGNN", "CMAPSS", "FD001", variables,
                                    platforms=("cpu",))
    from gnn_rul_tpu.export import save_artifact as jax_save_artifact
    jax_save_artifact(str(tmp_path / "jax.ghlo"), meta, blob)
    (tmp_path / "text.pt2").write_text("not an artifact")
    for name in ("other.pt2", "jax.ghlo", "text.pt2"):
        with pytest.raises(ValueError, match="serving artifact"):
            export.load_artifact(str(tmp_path / name), device="cpu")


def test_cli_refuses_a_jax_pickle(tmp_path):
    path = tmp_path / "checkpoint.pkl"
    path.write_bytes(b"")
    with pytest.raises(ValueError, match="from_jax_variables"):
        export.main(["--checkpoint", str(path), "--GNN_method", "FC_STGNN",
                     "--dataset", "CMAPSS", "--dataset_id", "FD001",
                     "--out", str(tmp_path / "m.pt2"), "--device", "cpu"])


def test_default_device_without_cuda_raises(tmp_path, monkeypatch):
    sd = from_jax_variables("FC_STGNN", seeded_variables("FC_STGNN"))
    meta, program = export.export_serving("FC_STGNN", "CMAPSS", "FD001", sd,
                                          device="cpu")
    path = export.save_artifact(str(tmp_path / "m.pt2"), meta, program)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export.export_serving("FC_STGNN", "CMAPSS", "FD001", sd)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        export.load_artifact(path)


@pytest.mark.cuda
@pytest.mark.parametrize("method", METHODS)
def test_cpu_artifact_launches_the_kernels_on_the_card(tmp_path, method):
    """An artifact exported on the CPU and loaded with device="cuda" calls
    the hand-written kernels (their launch counts move by the operator's
    calls a forward) and agrees with the live model on the card; here it
    skips."""
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the kernels run only on an NVIDIA GPU")
    sd = from_jax_variables(method, seeded_variables(method))
    meta, program = export.export_serving(method, "CMAPSS", "FD001", sd,
                                          device="cpu")
    path = export.save_artifact(str(tmp_path / "m.pt2"), meta, program)
    art = export.load_artifact(path, device="cuda")
    wrapper = {"fused_dot_graph_spmm": fused_gnn.fused_dot_graph_spmm,
               "lstm_recurrence": fused_lstm.lstm_recurrence,
               "fused_gat": fused_gat.fused_gat}[OPS[method][0]]
    x = _x(37, seed=3)
    before = wrapper.launches
    got = art(x)
    assert wrapper.launches == before + OPS[method][1]
    np.testing.assert_allclose(
        got, export.serving_model(method, "CMAPSS", "FD001", sd)(x),
        atol=LIVE_ATOL, rtol=LIVE_RTOL)
