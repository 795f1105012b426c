"""The port's STFA (gnn_rul_tpu_torch.models.stfa) against the JAX
package's at CMAPSS/FD001 full width, on the CPU: the same weights (carried
by from_jax_variables), the same seeded inputs. Covers the prior graph and
the ASE quirk, the eval forward, the train-mode forward and gradients with
dropout off (the JAX package's Dropout patched to the identity), the weight
round trip, a 2-epoch Engine trajectory, serving and the CLI."""

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
from gnn_rul_tpu.models.stfa import STFA as JaxSTFA
from gnn_rul_tpu.models.stfa import (
    prior_knowledge_graph as jax_prior_knowledge_graph)
from gnn_rul_tpu.nn import basic as jax_basic
from gnn_rul_tpu.train import algorithms as jalgorithms
from gnn_rul_tpu.train import engine as jengine
from gnn_rul_tpu_torch import cli
from gnn_rul_tpu_torch.compat import from_jax_variables
from gnn_rul_tpu_torch.configs import hparams as bank
from gnn_rul_tpu_torch.export import build_model, serving_model
from gnn_rul_tpu_torch.models.stfa import STFA, prior_knowledge_graph
from gnn_rul_tpu_torch.ops.kernels.fused_gat import fused_gat
from gnn_rul_tpu_torch.train import algorithms
from gnn_rul_tpu_torch.train.engine import Engine

from test_torch_cli import _write_fd001

torch.set_num_threads(1)

HP = hparams.model_hparams("CMAPSS", "FD001", "STFA")
TRAIN_PARAMS = {"num_epochs": 2, "batch_size": 4, "learning_rate": 1e-3,
                "weight_decay": 1e-4}
ROWS = 10          # two full batches of 4 and a remainder of 2 per epoch


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _x(rows, seed):
    return np.random.default_rng(seed).normal(size=(rows, 14, 50)).astype(
        np.float32)


def _no_jax_dropout(monkeypatch):
    """The JAX package's Dropout as the identity (its rate is fixed in the
    model), as tests/test_torch_logo.py does."""
    monkeypatch.setattr(jax_basic.Dropout, "__call__",
                        lambda self, x, train=False: x)


def _no_dropout(model):
    for m in model.modules():
        if isinstance(m, torch.nn.Dropout):
            m.p = 0.0
    return model


@pytest.fixture(scope="module")
def variables():
    model = JaxSTFA(**HP)
    return _numpy_tree(dict(model.init(jax.random.PRNGKey(0),
                                       jnp.zeros((4, 14, 50), jnp.float32),
                                       train=False)))


def _port(variables):
    model = STFA(**HP)
    model.load_state_dict(from_jax_variables("STFA", variables), strict=True)
    return model


def test_prior_graph_matches_jax():
    got = prior_knowledge_graph().numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_prior_knowledge_graph()))
    assert got.sum() == 44 and np.all(np.diagonal(got) == 0)
    assert "adj" not in STFA(**HP).state_dict()


def test_ase_global_feature_is_ones_and_v_gets_no_gradient(variables):
    model = _port(variables).eval()
    seen = {}

    def keep_input(mod, args, out):
        seen["x"] = args[0]

    model.lstm.register_forward_hook(keep_input)
    model(torch.from_numpy(_x(3, seed=1))).sum().backward()
    t = HP["num_patch"]
    assert torch.equal(seen["x"][..., :t], torch.ones(3, t, t))
    assert torch.count_nonzero(model.v.weight.grad) == 0
    assert torch.count_nonzero(model.v.bias.grad) == 0


@pytest.mark.parametrize("rows", [4, 10])
def test_eval_output_matches_jax(variables, rows):
    x = _x(rows, seed=rows)
    want = np.asarray(JaxSTFA(**HP).apply(variables, jnp.asarray(x),
                                          train=False))
    before = fused_gat.launches
    with torch.no_grad():
        got = _port(variables).eval()(torch.from_numpy(x)).numpy()
    assert fused_gat.launches == before  # CPU tensors: the plain version
    assert got.shape == want.shape == (rows, 1)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_train_mode_forward_and_gradients_match_jax(variables, monkeypatch):
    """Train mode with dropout off on both sides (the port's GAT then takes
    its fused path, the JAX package's its plain one): the output and the
    gradient of the mean square through the GAT backward, every parameter
    against jax.grad."""
    _no_jax_dropout(monkeypatch)
    x = _x(4, seed=0)
    jmodel = JaxSTFA(**HP)

    def loss(params):
        out = jmodel.apply({"params": params}, jnp.asarray(x), train=True,
                           rngs={"dropout": jax.random.PRNGKey(0)})
        return jnp.mean(out ** 2), out

    (_, want_out), want_grads = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])
    model = _no_dropout(_port(variables)).train()
    out = model(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=2e-4, rtol=1e-4)
    torch.mean(out ** 2).backward()
    grads = {k: p.grad for k, p in model.named_parameters()}
    got = import_torch_state_dict("STFA", grads, HP)["params"]
    want = dict(jax.tree_util.tree_leaves_with_path(
        _numpy_tree(want_grads)))
    leaves = jax.tree_util.tree_leaves_with_path(_numpy_tree(got))
    assert len(leaves) == len(want)
    for path, leaf in leaves:
        np.testing.assert_allclose(leaf, want[path], atol=2e-4, rtol=1e-4,
                                   err_msg=str(path))


def test_weight_carry_round_trips_exactly(variables):
    back = import_torch_state_dict("STFA", _port(variables).state_dict(), HP)
    want_leaves, want_tree = jax.tree_util.tree_flatten_with_path(variables)
    got_leaves, got_tree = jax.tree_util.tree_flatten_with_path(back)
    assert got_tree == want_tree
    for (path, want), (_, got) in zip(want_leaves, got_leaves):
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=str(path))


def test_build_model_and_spec_resolve_stfa():
    assert isinstance(build_model("STFA", "CMAPSS", "FD001"), STFA)
    spec = algorithms.get_algorithm_spec("STFA")
    assert spec.model_cls is STFA and spec.aux_weight is None


@pytest.fixture(scope="module")
def trajectories():
    """Two epochs of each engine from the same start, dropout off on both
    sides, the batches in the same order."""
    rng = np.random.default_rng(0)
    x = _x(ROWS, seed=20)
    y = rng.uniform(size=(ROWS, 1)).astype(np.float32)
    with pytest.MonkeyPatch.context() as mp:
        _no_jax_dropout(mp)
        jax_engine = jengine.Engine(
            JaxSTFA(**HP), jalgorithms.get_algorithm_spec("STFA"),
            TRAIN_PARAMS, seed=0)
        state = jax_engine.init_state(x)
        port = Engine(_no_dropout(_port({"params": _numpy_tree(
                          state.params)})),
                      algorithms.get_algorithm_spec("STFA"), TRAIN_PARAMS,
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
    """Every parameter, ``v`` included: its gradient is zero, and only the
    weight decay moves it, alike in both packages."""
    _, _, state, port = trajectories
    got = jax.tree_util.tree_leaves_with_path(_numpy_tree(
        import_torch_state_dict("STFA", port.model.state_dict(),
                                HP)["params"]))
    want = dict(jax.tree_util.tree_leaves_with_path(
        _numpy_tree(state.params)))
    assert len(got) == len(want)
    worst = max(float(np.max(np.abs(leaf - want[path])))
                for path, leaf in got)
    assert worst < 5e-4, f"parameters diverge by {worst}"
    assert fused_gat.launches == 0


def _jax_serving(variables, batch_size):
    meta, blob = export_serving("STFA", "CMAPSS", "FD001", variables,
                                batch_size=batch_size, platforms=("cpu",),
                                model_hparams=HP)
    return JaxServingModel(meta, jexport.deserialize(bytearray(blob)))


@pytest.mark.parametrize("batch_size,rows", [(4, 6), (None, 5)])
def test_serving_matches_jax_artifact(variables, batch_size, rows):
    want_model = _jax_serving(variables, batch_size)
    got_model = serving_model("STFA", "CMAPSS", "FD001",
                              from_jax_variables("STFA", variables),
                              batch_size=batch_size, device="cpu")
    assert got_model.meta["input_shape"] == want_model.meta["input_shape"]
    x = _x(rows, seed=rows + 10)
    got = got_model(x)
    assert got.shape == (rows,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want_model(x), atol=2e-4, rtol=1e-4)


def test_cli_trains_stfa_and_its_checkpoint_serves(tmp_path, monkeypatch):
    root = str(tmp_path)
    data_root = _write_fd001(root, n_train=20, n_test=6)
    orig = bank.train_params

    def small_batch(dataset, sub_id, method):
        return {**orig(dataset, sub_id, method), "batch_size": 8}

    monkeypatch.setattr(bank, "train_params", small_batch)
    results = cli.main([
        "--GNN_method", "STFA", "--dataset", "CMAPSS", "--dataset_id",
        "FD001", "--data_path", data_root, "--save_dir",
        os.path.join(root, "logs"), "--device", "cpu", "--epochs", "1",
        "--num_runs", "1"])

    best = results[0][None]
    assert len(best) == 4 and all(np.isfinite(v) for v in best)
    run_dir = os.path.join(root, "logs", "GNN_RUL", "run_1", "STFA_run_0")
    with open(os.path.join(run_dir, "results.csv")) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["Score_v1", "Score_v2", "MAE", "RMSE"]
    assert len(rows) == 2 and np.allclose([float(v) for v in rows[1]], best)

    path = os.path.join(run_dir, "checkpoint.pt")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    x = _x(7, seed=5)
    got = serving_model("STFA", "CMAPSS", "FD001", ckpt["model_dict"],
                        device="cpu")(x)
    jvars = import_torch_checkpoint(path, "STFA", dataset="CMAPSS",
                                    dataset_id="FD001")
    want = np.asarray(JaxSTFA(**ckpt["hparams"]).apply(
        jvars, jnp.asarray(x), train=False)).reshape(-1)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)
