"""The port's GRU_CM and STGNN (gnn_rul_tpu_torch.models.gru_cm, .stgnn)
against the JAX package's at CMAPSS/FD001 full width on the CPU (eval
forward, weight round trip, 5 Adam steps, symbolic-batch artifact), and
the recurrent layers they and the zoo use: GRULayer and the multi-layer
LSTM and GRU wrappers, against the JAX layers on the same weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_rul_tpu.nn import recurrent as jrecurrent
from gnn_rul_tpu_torch import export
from gnn_rul_tpu_torch.models.gru_cm import GRUCM, GNNLayer
from gnn_rul_tpu_torch.models.stgnn import STGNN
from gnn_rul_tpu_torch.nn.recurrent import GRU, LSTM, GRULayer
from gnn_rul_tpu_torch.ops.kernels.fused_lstm import lstm_recurrence
from gnn_rul_tpu_torch.train import algorithms

import test_torch_model_checks as checks

METHODS = ("GRU_CM", "STGNN")


@pytest.fixture(scope="module", params=METHODS)
def case(request):
    return request.param, checks.jax_variables(request.param)


@pytest.mark.parametrize("rows", [4, 10])
def test_eval_output_matches_jax(case, rows):
    method, variables = case
    assert checks.check_eval_forward(method, variables, rows,
                                     seed=rows) == 0


def test_weight_carry_round_trips_exactly(case):
    checks.check_round_trip(*case)


@pytest.mark.parametrize("method", METHODS)
def test_five_adam_steps_match_jax(method, monkeypatch):
    assert checks.check_trajectory(method, monkeypatch) == ("jax", "jax",
                                                            0.0)


def test_symbolic_artifact_matches_live_model(case, tmp_path):
    """No port kernel in the program: both models' recurrences are cuDNN's
    (aten.gru), whose weights load_artifact puts in one buffer on the
    card."""
    program = checks.check_symbolic_artifact(*case, tmp_path)
    assert checks.our_op_nodes(program) == 0
    assert sum(n.target is torch.ops.aten.gru.input
               for n in program.graph.nodes) == 1


@pytest.mark.parametrize("method,cls", [("GRU_CM", GRUCM), ("STGNN", STGNN)])
def test_build_model_and_spec_resolve(method, cls):
    spec = algorithms.get_algorithm_spec(method)
    assert spec.model_cls is cls and spec.aux_weight is None
    assert isinstance(checks.port_model(method, checks.jax_variables(
        method, seed=3)), cls)


def test_gru_cm_edge_panel_equals_the_concatenated_linear():
    """GNNLayer's two weight halves give the edge MLP on cat[x_i, x_j]
    (models/GRU_CM/Model.py:22-29) summed over the sources j."""
    torch.manual_seed(0)
    layer = GNNLayer(3, 5)
    x = torch.randn(2, 4, 6, 3)
    got = layer(x)
    pairs = torch.cat([x[..., :, None, :].expand(-1, -1, -1, 6, -1),
                       x[..., None, :, :].expand(-1, -1, 6, -1, -1)], dim=-1)
    edge = layer.edge_mlp(pairs).sum(dim=3)
    want = layer.node_mlp(torch.cat([x, edge], dim=-1))
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-5)


def _rnn_state(module, prefix=""):
    """A flax recurrent layer's params (w_ih (D, G), w_hh, b_ih, b_hh) as
    torch's weight_ih_l0 ... entries."""
    return {f"weight_ih_l0{prefix}": torch.tensor(module["w_ih"].T),
            f"weight_hh_l0{prefix}": torch.tensor(module["w_hh"].T),
            f"bias_ih_l0{prefix}": torch.tensor(module["b_ih"]),
            f"bias_hh_l0{prefix}": torch.tensor(module["b_hh"])}


def _seq(b=3, t=7, d=5, seed=0):
    return np.random.default_rng(seed).normal(size=(b, t, d)).astype(
        np.float32)


def test_gru_layer_matches_jax():
    x = _seq()
    jlayer = jrecurrent.GRULayer(6)
    jvars = checks.numpy_tree(jlayer.init(jax.random.PRNGKey(0),
                                          jnp.asarray(x)))
    want_ys, want_h = jlayer.apply(jvars, jnp.asarray(x))
    layer = GRULayer(5, 6)
    layer.load_state_dict(_rnn_state(jvars["params"]), strict=True)
    with torch.no_grad():
        ys, h = layer(torch.from_numpy(x))
    assert ys.shape == (3, 7, 6) and h.shape == (3, 6)
    np.testing.assert_allclose(ys.numpy(), np.asarray(want_ys), atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=1e-6,
                               rtol=1e-5)


def _layer_states(params, num_layers, bidirectional):
    """The JAX LSTM's l{k}_fwd / l{k}_bwd (or GRU's l{k}) as torch keys."""
    sd = {}
    for k in range(num_layers):
        name = f"l{k}_fwd" if f"l{k}_fwd" in params else f"l{k}"
        for key, v in _rnn_state(params[name]).items():
            sd[key.replace("_l0", f"_l{k}")] = v
        if bidirectional:
            for key, v in _rnn_state(params[f"l{k}_bwd"], "_reverse").items():
                sd[key.replace("_l0", f"_l{k}")] = v
    return sd


@pytest.mark.parametrize("bidirectional", [False, True])
def test_multi_layer_lstm_matches_jax(bidirectional):
    """Two layers; bidirectional through bilstm_fused (the recurrence
    operator: its plain version here), unidirectional through nn.LSTM."""
    x = _seq(seed=1)
    jlstm = jrecurrent.LSTM(6, num_layers=2, bidirectional=bidirectional)
    jvars = checks.numpy_tree(jlstm.init(jax.random.PRNGKey(1),
                                         jnp.asarray(x)))
    want_ys, (want_h, want_c) = jlstm.apply(jvars, jnp.asarray(x))
    lstm = LSTM(5, 6, num_layers=2, bidirectional=bidirectional)
    lstm.load_state_dict(_layer_states(jvars["params"], 2, bidirectional),
                         strict=True)
    before = lstm_recurrence.launches
    with torch.no_grad():
        ys, (h, c) = lstm(torch.from_numpy(x))
    assert lstm_recurrence.launches == before
    dirs = 2 if bidirectional else 1
    assert ys.shape == (3, 7, 6 * dirs) and h.shape == c.shape == (2 * dirs,
                                                                   3, 6)
    for got, want in ((ys, want_ys), (h, want_h), (c, want_c)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                                   rtol=1e-5)


def test_multi_layer_gru_matches_jax():
    x = _seq(seed=2)
    jgru = jrecurrent.GRU(6, num_layers=2)
    jvars = checks.numpy_tree(jgru.init(jax.random.PRNGKey(2),
                                        jnp.asarray(x)))
    want_ys, want_h = jgru.apply(jvars, jnp.asarray(x))
    gru = GRU(5, 6, num_layers=2)
    gru.load_state_dict(_layer_states(jvars["params"], 2, False), strict=True)
    with torch.no_grad():
        ys, h = gru(torch.from_numpy(x))
    assert ys.shape == (3, 7, 6) and h.shape == (2, 3, 6)
    np.testing.assert_allclose(ys.numpy(), np.asarray(want_ys), atol=1e-6,
                               rtol=1e-5)
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=1e-6,
                               rtol=1e-5)


@pytest.mark.parametrize("method,op", [("GRU_CM", "gru"), ("STGNN", "gru"),
                                       ("RGCNU", "lstm")])
def test_flattening_rnn_weights_is_a_no_op_on_the_cpu(method, op):
    """load_artifact puts the weights of each aten.gru and aten.lstm call in
    one cuDNN buffer on the card; on the CPU, where cuDNN takes none, the
    pass leaves every weight where it was."""
    sd = checks.from_jax_variables(method, checks.jax_variables(method))
    _, program = export.export_serving(method, "CMAPSS", "FD001", sd,
                                       device="cpu")
    module = program.module()
    target = getattr(torch.ops.aten, op).input
    calls = [n for n in module.graph.nodes if n.target is target]
    assert len(calls) == 1
    weights = [module.get_parameter(p.target) for p in calls[0].args[2]]
    before = [(w.data_ptr(), w.clone()) for w in weights]
    export._flatten_rnn_weights(module)
    after = [module.get_parameter(p.target) for p in calls[0].args[2]]
    for (ptr, value), w in zip(before, after):
        assert w.data_ptr() == ptr and torch.equal(w, value)
