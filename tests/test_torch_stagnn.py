"""The port's STAGNN (gnn_rul_tpu_torch.models.stagnn) against the JAX
package's at CMAPSS/FD001 full width, on the CPU: the same weights (carried
by from_jax_variables), the same seeded inputs. Covers the eval and
train-mode forwards, the gradients through the GAT backward, the weight
round trip, a 2-epoch Engine trajectory, serving and the CLI.

STAGNN's adjacency is ``cov > 0`` per window: every input here keeps its
covariances more than 1e-4 from 0, so the two packages build the same
graphs."""

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
from gnn_rul_tpu.models.stagnn import STAGNN as JaxSTAGNN
from gnn_rul_tpu.train import algorithms as jalgorithms
from gnn_rul_tpu.train import engine as jengine
from gnn_rul_tpu_torch import cli
from gnn_rul_tpu_torch.compat import from_jax_variables
from gnn_rul_tpu_torch.configs import hparams as bank
from gnn_rul_tpu_torch.export import build_model, serving_model
from gnn_rul_tpu_torch.models.stagnn import STAGNN
from gnn_rul_tpu_torch.ops.kernels.fused_gat import fused_gat
from gnn_rul_tpu_torch.train import algorithms
from gnn_rul_tpu_torch.train.engine import Engine

from test_torch_attention import _min_abs_cov
from test_torch_cli import _write_fd001

torch.set_num_threads(1)

HP = hparams.model_hparams("CMAPSS", "FD001", "STAGNN")
TRAIN_PARAMS = {"num_epochs": 2, "batch_size": 4, "learning_rate": 1e-3,
                "weight_decay": 1e-4}
ROWS = 10          # two full batches of 4 and a remainder of 2 per epoch
# The fewest rows a BN layer sees: the remainder batch of 2 x the TCN's
# length of 64 (hidden_dim).
SMALLEST_BN_ROWS = 2 * 64


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _x(rows, seed):
    x = np.random.default_rng(seed).normal(size=(rows, 14, 50)).astype(
        np.float32)
    assert _min_abs_cov(x) > 1e-4
    return x


@pytest.fixture(scope="module")
def variables():
    """Seeded JAX weights, with running statistics moved off (0, 1) so that
    eval-mode BN is not the identity."""
    model = JaxSTAGNN(**HP)
    v = _numpy_tree(dict(model.init(jax.random.PRNGKey(0),
                                    jnp.zeros((4, 14, 50), jnp.float32),
                                    train=False)))
    rng = np.random.default_rng(0)
    v["batch_stats"] = jax.tree_util.tree_map_with_path(
        lambda path, a: (rng.normal(size=a.shape) * 0.5 if path[-1].key ==
                         "mean" else rng.uniform(0.5, 2.0, size=a.shape)
                         ).astype(np.float32), v["batch_stats"])
    return v


def _port(variables):
    model = STAGNN(**HP)
    model.load_state_dict(from_jax_variables("STAGNN", variables),
                          strict=True)
    return model


@pytest.mark.parametrize("rows", [4, 10])
def test_eval_output_matches_jax(variables, rows):
    x = _x(rows, seed=rows)
    want = np.asarray(JaxSTAGNN(**HP).apply(variables, jnp.asarray(x),
                                            train=False))
    before = fused_gat.launches
    with torch.no_grad():
        got = _port(variables).eval()(torch.from_numpy(x)).numpy()
    assert fused_gat.launches == before  # CPU tensors: the plain version
    assert got.shape == want.shape == (rows, 1)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_train_mode_forward_and_gradients_match_jax(variables):
    """Train mode (batch statistics in the TCNs' BNs; the GATs have no
    dropout, so both packages take the fused path): the output and the
    gradient of the mean square through the GAT backward, every parameter
    against jax.grad."""
    x = _x(4, seed=2)
    jmodel = JaxSTAGNN(**HP)

    def loss(params):
        out, _ = jmodel.apply({"params": params,
                               "batch_stats": variables["batch_stats"]},
                              jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
        return jnp.mean(out ** 2), out

    (_, want_out), want_grads = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])
    model = _port(variables).train()
    out = model(torch.from_numpy(x))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out),
                               atol=2e-4, rtol=1e-4)
    torch.mean(out ** 2).backward()
    # The buffers only fill the mapping's batch_stats, which are not read.
    grads = {**model.state_dict(),
             **{k: p.grad for k, p in model.named_parameters()}}
    got = import_torch_state_dict("STAGNN", grads, HP)["params"]
    want = dict(jax.tree_util.tree_leaves_with_path(
        _numpy_tree(want_grads)))
    leaves = jax.tree_util.tree_leaves_with_path(_numpy_tree(got))
    assert len(leaves) == len(want)
    for path, leaf in leaves:
        np.testing.assert_allclose(leaf, want[path], atol=2e-4, rtol=1e-4,
                                   err_msg=str(path))


def test_weight_carry_round_trips_exactly(variables):
    back = import_torch_state_dict("STAGNN", _port(variables).state_dict(),
                                   HP)
    want_leaves, want_tree = jax.tree_util.tree_flatten_with_path(variables)
    got_leaves, got_tree = jax.tree_util.tree_flatten_with_path(back)
    assert got_tree == want_tree
    for (path, want), (_, got) in zip(want_leaves, got_leaves):
        assert got.dtype == want.dtype, path
        np.testing.assert_array_equal(got, want, err_msg=str(path))


def test_downsample_bias_is_carried(variables):
    sd = from_jax_variables("STAGNN", variables)
    for tcn in ("tcn1", "tcn2"):
        np.testing.assert_array_equal(
            sd[f"{tcn}.downsample0.bias"].numpy(),
            variables["params"][tcn]["downsample0"]["Conv_0"]["bias"])
        assert f"{tcn}.conv_block1.0.bias" not in sd


def test_build_model_and_spec_resolve_stagnn():
    assert isinstance(build_model("STAGNN", "CMAPSS", "FD001"), STAGNN)
    spec = algorithms.get_algorithm_spec("STAGNN")
    assert spec.model_cls is STAGNN and spec.aux_weight is None


@pytest.fixture(scope="module")
def trajectories():
    """Two epochs of each engine from the same start, the batches in the
    same order."""
    rng = np.random.default_rng(0)
    x = _x(ROWS, seed=20)
    y = rng.uniform(size=(ROWS, 1)).astype(np.float32)
    jax_engine = jengine.Engine(
        JaxSTAGNN(**HP), jalgorithms.get_algorithm_spec("STAGNN"),
        TRAIN_PARAMS, seed=0)
    state = jax_engine.init_state(x)
    port = Engine(_port({"params": _numpy_tree(state.params),
                         "batch_stats": _numpy_tree(state.batch_stats)}),
                  algorithms.get_algorithm_spec("STAGNN"), TRAIN_PARAMS,
                  seed=0, device="cpu")
    jax_losses, port_losses = [], []
    for epoch in (1, 2):
        state, loss = jax_engine.run_epoch(state, x, y, epoch, shuffle=False)
        jax_losses.append(loss)
        port_losses.append(port.run_epoch(x, y, epoch, shuffle=False))
    return jax_losses, port_losses, state, port


def test_epoch_losses_match_jax(trajectories):
    jax_losses, port_losses, _, _ = trajectories
    np.testing.assert_allclose(port_losses, jax_losses, rtol=2e-4, atol=2e-5)


def _port_variables(port):
    return _numpy_tree(import_torch_state_dict(
        "STAGNN", port.model.state_dict(), HP))


def test_parameters_match_jax(trajectories):
    _, _, state, port = trajectories
    got = jax.tree_util.tree_leaves_with_path(_port_variables(port)["params"])
    want = dict(jax.tree_util.tree_leaves_with_path(
        _numpy_tree(state.params)))
    assert len(got) == len(want)
    worst = max(float(np.max(np.abs(leaf - want[path])))
                for path, leaf in got)
    assert worst < 5e-4, f"parameters diverge by {worst}"
    assert fused_gat.launches == 0


def test_running_statistics_match_jax(trajectories):
    """Running means at the JAX parity tests' tolerance; running variances
    within the bound of the biased/unbiased variance gap (ROADMAP.md Queue
    3; tests/test_torch_training.py states the bound), never smaller than
    the JAX package's."""
    _, _, state, port = trajectories
    got = dict(jax.tree_util.tree_leaves_with_path(
        _port_variables(port)["batch_stats"]))
    want = jax.tree_util.tree_leaves_with_path(
        _numpy_tree(state.batch_stats))
    assert len(got) == len(want) == 8
    for path, leaf in want:
        if path[-1].key == "mean":
            np.testing.assert_allclose(got[path], leaf, atol=5e-4,
                                       rtol=1e-3, err_msg=str(path))
        else:
            np.testing.assert_allclose(
                got[path], leaf, atol=5e-4,
                rtol=1e-3 + 1.0 / (SMALLEST_BN_ROWS - 1), err_msg=str(path))
            assert np.all(got[path] >= leaf - 5e-4), path


def _jax_serving(variables, batch_size):
    meta, blob = export_serving("STAGNN", "CMAPSS", "FD001", variables,
                                batch_size=batch_size, platforms=("cpu",),
                                model_hparams=HP)
    return JaxServingModel(meta, jexport.deserialize(bytearray(blob)))


@pytest.mark.parametrize("batch_size,rows", [(4, 6), (None, 5)])
def test_serving_matches_jax_artifact(variables, batch_size, rows):
    want_model = _jax_serving(variables, batch_size)
    got_model = serving_model("STAGNN", "CMAPSS", "FD001",
                              from_jax_variables("STAGNN", variables),
                              batch_size=batch_size, device="cpu")
    assert got_model.meta["input_shape"] == want_model.meta["input_shape"]
    x = _x(rows, seed=rows + 20)
    got = got_model(x)
    assert got.shape == (rows,) and got.dtype == np.float32
    np.testing.assert_allclose(got, want_model(x), atol=2e-4, rtol=1e-4)


def _with_dead_tcn_keys(sd, prefix=""):
    """``sd`` plus tensors under the reference TemporalConvNet's unused
    weight-normed ``net0``/``net1`` submodules, as a reference checkpoint's
    model_dict carries them."""
    rng = np.random.default_rng(9)
    dead = {f"{prefix}{tcn}.{sub}.0.{leaf}": torch.from_numpy(
                rng.normal(size=shape).astype(np.float32))
            for tcn in ("tcn1", "tcn2") for sub in ("net0", "net1")
            for leaf, shape in (("weight_g", (64, 1, 1)),
                                ("weight_v", (64, 64, 2)), ("bias", (64,)))}
    return {**{f"{prefix}{k}": v for k, v in sd.items()}, **dead}


@pytest.mark.parametrize("prefix", ["", "model."])
def test_serving_loads_dead_tcn_keys_and_matches_jax(variables, prefix):
    """A state_dict with the dead tcn*.net0/net1 keys (bare, or under the
    algorithm's "model." prefix) serves as the JAX model does; the JAX
    importer reads the same dict."""
    sd = _with_dead_tcn_keys(from_jax_variables("STAGNN", variables), prefix)
    got = serving_model("STAGNN", "CMAPSS", "FD001", sd, device="cpu")
    x = _x(5, seed=31)
    want = np.asarray(JaxSTAGNN(**HP).apply(variables, jnp.asarray(x),
                                            train=False)).reshape(-1)
    np.testing.assert_allclose(got(x), want, atol=2e-4, rtol=1e-4)
    jvars = import_torch_state_dict("STAGNN", sd, HP)
    np.testing.assert_allclose(
        np.asarray(JaxSTAGNN(**HP).apply(jvars, jnp.asarray(x),
                                         train=False)).reshape(-1),
        want, atol=1e-6)


@pytest.mark.parametrize("bad", ["tcn1.net2.weight", "gcn1.bogus",
                                 "net0.weight", "missing"])
def test_serving_still_refuses_other_unexpected_or_missing_keys(variables,
                                                                bad):
    sd = _with_dead_tcn_keys(from_jax_variables("STAGNN", variables))
    if bad == "missing":
        del sd["tcn1.downsample0.bias"]
    else:
        sd[bad] = torch.zeros(3)
    with pytest.raises(RuntimeError, match="Missing key|Unexpected key"):
        serving_model("STAGNN", "CMAPSS", "FD001", sd, device="cpu")


def test_cli_trains_stagnn_and_its_checkpoint_serves(tmp_path, monkeypatch):
    root = str(tmp_path)
    data_root = _write_fd001(root, n_train=20, n_test=6)
    orig = bank.train_params

    def small_batch(dataset, sub_id, method):
        return {**orig(dataset, sub_id, method), "batch_size": 8}

    monkeypatch.setattr(bank, "train_params", small_batch)
    results = cli.main([
        "--GNN_method", "STAGNN", "--dataset", "CMAPSS", "--dataset_id",
        "FD001", "--data_path", data_root, "--save_dir",
        os.path.join(root, "logs"), "--device", "cpu", "--epochs", "1",
        "--num_runs", "1"])

    best = results[0][None]
    assert len(best) == 4 and all(np.isfinite(v) for v in best)
    run_dir = os.path.join(root, "logs", "GNN_RUL", "run_1", "STAGNN_run_0")
    with open(os.path.join(run_dir, "results.csv")) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["Score_v1", "Score_v2", "MAE", "RMSE"]
    assert len(rows) == 2 and np.allclose([float(v) for v in rows[1]], best)

    path = os.path.join(run_dir, "checkpoint.pt")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    x = _x(7, seed=5)
    got = serving_model("STAGNN", "CMAPSS", "FD001", ckpt["model_dict"],
                        device="cpu")(x)
    jvars = import_torch_checkpoint(path, "STAGNN", dataset="CMAPSS",
                                    dataset_id="FD001")
    want = np.asarray(JaxSTAGNN(**ckpt["hparams"]).apply(
        jvars, jnp.asarray(x), train=False)).reshape(-1)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)
