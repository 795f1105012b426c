"""The port's LOGO (gnn_rul_tpu_torch.models.logo) against the JAX
package's at CMAPSS/FD001 full width, on the CPU: the same weights (carried
by from_jax_variables), the same seeded inputs. Covers the eval forward,
the train-mode graph regularization loss, the weight round trip, a 2-epoch
Engine trajectory, padded evaluation, serving and the CLI."""

import csv
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import export as jexport

from gnn_rul_tpu.compat import import_torch_checkpoint, import_torch_state_dict
from gnn_rul_tpu.configs import hparams
from gnn_rul_tpu.export import ServingModel as JaxServingModel
from gnn_rul_tpu.export import export_serving
from gnn_rul_tpu.models.logo import LOGO as JaxLOGO
from gnn_rul_tpu.nn import basic as jax_basic
from gnn_rul_tpu.train import algorithms as jalgorithms
from gnn_rul_tpu.train import engine as jengine
from gnn_rul_tpu_torch import cli
from gnn_rul_tpu_torch.compat import from_jax_variables
from gnn_rul_tpu_torch.configs import hparams as bank
from gnn_rul_tpu_torch.export import build_model, serving_model
from gnn_rul_tpu_torch.models.logo import LOGO
from gnn_rul_tpu_torch.ops.kernels.fused_lstm import lstm_recurrence
from gnn_rul_tpu_torch.train import algorithms
from gnn_rul_tpu_torch.train.engine import Engine

from test_torch_cli import _write_fd001

torch.set_num_threads(1)

HP = hparams.model_hparams("CMAPSS", "FD001", "LOGO")
TRAIN_PARAMS = {"num_epochs": 2, "batch_size": 4, "learning_rate": 1e-3,
                "weight_decay": 1e-4, "theta": 0.001}
ROWS = 10          # two full batches of 4 and a remainder of 2 per epoch


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def seeded_variables(seed=0):
    model = JaxLOGO(**HP)
    variables = model.init(jax.random.PRNGKey(seed),
                           jnp.zeros((4, 14, 50), jnp.float32), train=False)
    return _numpy_tree(dict(variables))


def _port(variables, dropout=True):
    model = LOGO(**HP)
    model.load_state_dict(from_jax_variables("LOGO", variables), strict=True)
    if not dropout:
        model.TD.drop2.p = model.TD.drop3.p = 0.0
    return model


def _no_jax_dropout(monkeypatch):
    """The JAX package's Dropout as the identity (its rate is fixed in the
    model), as tests/test_parity_aux_losses.py does."""
    monkeypatch.setattr(jax_basic.Dropout, "__call__",
                        lambda self, x, train=False: x)


@pytest.fixture(scope="module")
def variables():
    return seeded_variables()


def _x(rows, seed):
    return np.random.default_rng(seed).normal(size=(rows, 14, 50)).astype(
        np.float32)


@pytest.mark.parametrize("rows", [4, 10])
def test_eval_output_matches_jax(variables, rows):
    x = _x(rows, seed=rows)
    want = np.asarray(JaxLOGO(**HP).apply(variables, jnp.asarray(x),
                                          train=False))
    with torch.no_grad():
        got = _port(variables).eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (rows, 1)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_train_mode_gl_loss_matches_jax(variables, monkeypatch):
    _no_jax_dropout(monkeypatch)
    x = _x(4, seed=0)
    want_pred, want_gl = JaxLOGO(**HP).apply(
        variables, jnp.asarray(x), train=True,
        rngs={"dropout": jax.random.PRNGKey(0)})
    with torch.no_grad():
        got_pred, got_gl = _port(variables, dropout=False).train()(
            torch.from_numpy(x))
    np.testing.assert_allclose(float(got_gl), float(want_gl), rtol=1e-4)
    np.testing.assert_allclose(got_pred.numpy(), np.asarray(want_pred),
                               atol=2e-4, rtol=1e-4)


def test_weight_carry_round_trips_exactly(variables):
    back = import_torch_state_dict("LOGO", _port(variables).state_dict(), HP)
    want_leaves, want_tree = jax.tree_util.tree_flatten_with_path(variables)
    got_leaves, got_tree = jax.tree_util.tree_flatten_with_path(back)
    assert got_tree == want_tree
    for (path, want), (_, got) in zip(want_leaves, got_leaves):
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=str(path))


def test_build_model_and_spec_resolve_logo():
    assert isinstance(build_model("LOGO", "CMAPSS", "FD001"), LOGO)
    spec = algorithms.get_algorithm_spec("LOGO")
    assert spec.model_cls is LOGO and spec.aux_weight == "theta"
    assert algorithms.resolve_aux_weight(
        spec, bank.train_params("CMAPSS", "FD001", "LOGO")) == 0.001


@pytest.fixture(scope="module")
def trajectories():
    """Two epochs of each engine from the same start, dropout off on both
    sides, the batches in the same order."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(ROWS, 14, 50)).astype(np.float32)
    y = rng.uniform(size=(ROWS, 1)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        _no_jax_dropout(mp)
        jax_engine = jengine.Engine(
            JaxLOGO(**HP), jalgorithms.get_algorithm_spec("LOGO"),
            TRAIN_PARAMS, seed=0)
        state = jax_engine.init_state(x)
        port = Engine(_port({"params": _numpy_tree(state.params)},
                            dropout=False),
                      algorithms.get_algorithm_spec("LOGO"), TRAIN_PARAMS,
                      seed=0, device="cpu")
        jax_losses, port_losses = [], []
        for epoch in (1, 2):
            state, loss = jax_engine.run_epoch(state, x, y, epoch,
                                               shuffle=False)
            jax_losses.append(loss)
            port_losses.append(port.run_epoch(x, y, epoch, shuffle=False))
    return jax_losses, port_losses, state, port


def test_epoch_losses_match_jax(trajectories):
    jax_losses, port_losses, _, _ = trajectories
    np.testing.assert_allclose(port_losses, jax_losses, rtol=2e-4, atol=2e-5)


def test_parameters_match_jax(trajectories):
    _, _, state, port = trajectories
    got = jax.tree_util.tree_leaves_with_path(_numpy_tree(
        import_torch_state_dict("LOGO", port.model.state_dict(), HP)
        ["params"]))
    want = dict(jax.tree_util.tree_leaves_with_path(
        _numpy_tree(state.params)))
    assert len(got) == len(want)
    worst = max(float(np.max(np.abs(leaf - want[path])))
                for path, leaf in got)
    assert worst < 5e-4, f"parameters diverge by {worst}"
    assert lstm_recurrence.launches == lstm_recurrence.bwd_launches == 0


def test_evaluate_pads_like_jax_and_padding_reaches_real_rows(variables):
    """Ten rows at an eval batch of 4: the last forward holds two real rows
    and two copies of the last. Both engines pad alike and agree; the
    batch-axis recurrence carries the padding into the real rows' answers,
    so the padded answers differ from one forward over all ten rows."""
    x = _x(ROWS, seed=1)
    jax_engine = jengine.Engine(JaxLOGO(**HP),
                                jalgorithms.get_algorithm_spec("LOGO"),
                                TRAIN_PARAMS, seed=2, eval_batch_size=4)
    state = jax_engine.init_state(x)
    params = {"params": _numpy_tree(state.params)}
    port = Engine(_port(params), algorithms.get_algorithm_spec("LOGO"),
                  TRAIN_PARAMS, seed=2, eval_batch_size=4, device="cpu")
    got = port.evaluate(x)
    assert got.shape == (ROWS,) and got.dtype == np.float32
    np.testing.assert_allclose(got, jax_engine.evaluate(state, x),
                               atol=2e-4, rtol=1e-4)
    with torch.no_grad():
        whole = port.model(torch.from_numpy(x)).reshape(-1).numpy()
    assert np.abs(got - whole).max() > 1e-4


def _jax_serving(variables, batch_size):
    meta, blob = export_serving("LOGO", "CMAPSS", "FD001", variables,
                                batch_size=batch_size, platforms=("cpu",),
                                model_hparams=HP)
    return JaxServingModel(meta, jexport.deserialize(bytearray(blob)))


@pytest.mark.parametrize("batch_size,rows", [(4, 6), (None, 5)])
def test_serving_matches_jax_artifact(variables, batch_size, rows):
    want_model = _jax_serving(variables, batch_size)
    got_model = serving_model("LOGO", "CMAPSS", "FD001",
                              from_jax_variables("LOGO", variables),
                              batch_size=batch_size, device="cpu")
    assert got_model.meta["input_shape"] == want_model.meta["input_shape"]
    x = _x(rows, seed=rows + 10)
    got = got_model(x)
    assert got.shape == (rows,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want_model(x), atol=2e-4, rtol=1e-4)


def test_cli_trains_logo_and_its_checkpoint_serves(tmp_path, monkeypatch):
    root = str(tmp_path)
    data_root = _write_fd001(root, n_train=20, n_test=6)
    orig = bank.train_params

    def small_batch(dataset, sub_id, method):
        return {**orig(dataset, sub_id, method), "batch_size": 8}

    monkeypatch.setattr(bank, "train_params", small_batch)
    results = cli.main([
        "--GNN_method", "LOGO", "--dataset", "CMAPSS", "--dataset_id",
        "FD001", "--data_path", data_root, "--save_dir",
        os.path.join(root, "logs"), "--device", "cpu", "--epochs", "1",
        "--num_runs", "1"])

    best = results[0][None]
    assert len(best) == 4 and all(np.isfinite(v) for v in best)
    run_dir = os.path.join(root, "logs", "GNN_RUL", "run_1", "LOGO_run_0")
    with open(os.path.join(run_dir, "results.csv")) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["Score_v1", "Score_v2", "MAE", "RMSE"]
    assert len(rows) == 2 and np.allclose([float(v) for v in rows[1]], best)

    path = os.path.join(run_dir, "checkpoint.pt")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    assert ckpt["train_params"]["theta"] == 0.001
    x = _x(7, seed=5)
    got = serving_model("LOGO", "CMAPSS", "FD001", ckpt["model_dict"],
                        device="cpu")(x)
    jvars = import_torch_checkpoint(path, "LOGO", dataset="CMAPSS",
                                    dataset_id="FD001")
    want = np.asarray(JaxLOGO(**ckpt["hparams"]).apply(
        jvars, jnp.asarray(x), train=False)).reshape(-1)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)
