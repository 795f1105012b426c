"""The port's training path (gnn_rul_tpu_torch.train) against the JAX
package's, on the CPU: the same weights (carried by from_jax_variables), the
same seeded batches in the same order, no dropout."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_rul_tpu.compat import import_torch_state_dict
from gnn_rul_tpu.configs import hparams
from gnn_rul_tpu.models.fc_stgnn import FCSTGNN as JaxFCSTGNN
from gnn_rul_tpu.nn.basic import BatchNorm1d as JaxBatchNorm1d
from gnn_rul_tpu.train import algorithms as jalgorithms
from gnn_rul_tpu.train import engine as jengine
from gnn_rul_tpu.train.metrics import calc_metrics as jax_calc_metrics
from gnn_rul_tpu_torch.compat import from_jax_variables
from gnn_rul_tpu_torch.export import resolve_device
from gnn_rul_tpu_torch.models.fc_stgnn import FCSTGNN
from gnn_rul_tpu_torch.nn.basic import BatchNorm1d
from gnn_rul_tpu_torch.ops.kernels.fused_gnn import fused_dot_graph_spmm
from gnn_rul_tpu_torch.train import algorithms
from gnn_rul_tpu_torch.train.engine import Engine, mse
from gnn_rul_tpu_torch.train.metrics import calc_metrics
from gnn_rul_tpu_torch.train.trainer import Trainer

torch.set_num_threads(1)

HP = hparams.model_hparams("CMAPSS", "FD001", "FC_STGNN")
TRAIN_PARAMS = {"num_epochs": 2, "batch_size": 4, "learning_rate": 1e-3,
                "weight_decay": 1e-4}
ROWS = 10          # two full batches of 4 and a remainder of 2 per epoch
SMALLEST_BN_ROWS = 2 * 2 * 14   # remainder batch x patches x nodes


def _numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _data(seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(ROWS, 14, 50)).astype(np.float32)
    y = rng.uniform(size=(ROWS, 1)).astype(np.float32)
    return x, y


@pytest.fixture(scope="module", params=["off", "on"])
def trajectories(request):
    """Two epochs of each engine from the same start; ``fused="on"`` runs
    the JAX package's Pallas forward and backward in interpret mode."""
    x, y = _data()
    jax_engine = jengine.Engine(
        JaxFCSTGNN(**HP, fused=request.param, pe_dropout=0.0),
        jalgorithms.get_algorithm_spec("FC_STGNN"), TRAIN_PARAMS, seed=0)
    state = jax_engine.init_state(x)
    start = {"params": _numpy_tree(state.params),
             "batch_stats": _numpy_tree(state.batch_stats)}
    model = FCSTGNN(**HP, pe_dropout=0.0)
    model.load_state_dict(from_jax_variables("FC_STGNN", start), strict=True)
    port = Engine(model, algorithms.get_algorithm_spec("FC_STGNN"),
                  TRAIN_PARAMS, seed=0, device="cpu")
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
    return _numpy_tree(import_torch_state_dict("FC_STGNN",
                                               port.model.state_dict()))


def test_parameters_match_jax(trajectories):
    _, _, state, port = trajectories
    got = jax.tree_util.tree_leaves_with_path(
        _port_variables(port)["params"])
    want = dict(jax.tree_util.tree_leaves_with_path(
        _numpy_tree(state.params)))
    assert len(got) == len(want)
    worst = max(float(np.max(np.abs(leaf - want[path])))
                for path, leaf in got)
    assert worst < 5e-4, f"parameters diverge by {worst}"


def test_running_statistics_match_jax(trajectories):
    """Running means at the JAX parity tests' tolerance. Running variances:
    torch's BatchNorm folds the unbiased batch variance into them and the
    JAX package's (flax) the biased one, so each step adds at most
    0.1 * var / (n - 1) to the gap while the gap decays by 0.9. The summed
    gap is then at most running_var / (n - 1) for the smallest n a BN layer
    sees here (56 rows), on top of the means' tolerance; and the port's
    variance is never the smaller."""
    _, _, state, port = trajectories
    got = dict(jax.tree_util.tree_leaves_with_path(
        _port_variables(port)["batch_stats"]))
    want = jax.tree_util.tree_leaves_with_path(
        _numpy_tree(state.batch_stats))
    assert len(got) == len(want)
    for path, leaf in want:
        if path[-1].key == "mean":
            np.testing.assert_allclose(got[path], leaf, atol=5e-4,
                                       rtol=1e-3, err_msg=str(path))
        else:
            np.testing.assert_allclose(
                got[path], leaf, atol=5e-4,
                rtol=1e-3 + 1.0 / (SMALLEST_BN_ROWS - 1), err_msg=str(path))
            assert np.all(got[path] >= leaf - 5e-4), path


def test_evaluate_pads_and_trims_like_jax():
    """Ten rows at an eval batch of 4: three forwards, two padded rows."""
    x, y = _data(seed=1)
    jax_engine = jengine.Engine(
        JaxFCSTGNN(**HP, fused="off"),
        jalgorithms.get_algorithm_spec("FC_STGNN"), TRAIN_PARAMS, seed=2,
        eval_batch_size=4)
    state = jax_engine.init_state(x)
    model = FCSTGNN(**HP)
    model.load_state_dict(from_jax_variables("FC_STGNN", {
        "params": _numpy_tree(state.params),
        "batch_stats": _numpy_tree(state.batch_stats)}), strict=True)
    port = Engine(model, algorithms.get_algorithm_spec("FC_STGNN"),
                  TRAIN_PARAMS, seed=2, eval_batch_size=4, device="cpu")
    got = port.evaluate(x)
    assert got.shape == (ROWS,) and got.dtype == np.float32
    np.testing.assert_allclose(got, jax_engine.evaluate(state, x),
                               atol=2e-4, rtol=1e-4)
    with torch.no_grad():
        whole = model(torch.from_numpy(x)).reshape(-1).numpy()
    np.testing.assert_allclose(got, whole, atol=1e-6, rtol=1e-6)


def test_training_counts_no_launch_on_the_cpu():
    x, y = _data(seed=2)
    model = FCSTGNN(**HP)
    port = Engine(model, algorithms.get_algorithm_spec("FC_STGNN"),
                  TRAIN_PARAMS, device="cpu")
    loss = port.run_epoch(x, y, 1, shuffle=True)
    assert np.isfinite(loss)
    assert fused_dot_graph_spmm.launches == 0
    assert fused_dot_graph_spmm.bwd_launches == 0


def test_batchnorm_running_variance_differs_by_the_bias_correction():
    """One train step of each package's BatchNorm1d on the same n rows:
    the running means agree, and the running variances differ by exactly
    0.1 * var / (n - 1), var the biased batch variance (torch keeps the
    unbiased one, flax the biased one)."""
    n, c = 56, 5
    x = np.random.default_rng(3).normal(2.0, 1.5, size=(n, c)).astype(
        np.float32)
    port = BatchNorm1d(c).train()
    port(torch.from_numpy(x))
    jax_bn = JaxBatchNorm1d()
    variables = jax_bn.init(jax.random.PRNGKey(0), jnp.asarray(x),
                            train=False)
    _, updates = jax_bn.apply(variables, jnp.asarray(x), train=True,
                              mutable=["batch_stats"])
    stats = updates["batch_stats"]["BatchNorm_0"]
    np.testing.assert_allclose(port.running_mean.numpy(),
                               np.asarray(stats["mean"]), atol=1e-6,
                               rtol=1e-6)
    var = x.astype(np.float64).var(axis=0)
    np.testing.assert_allclose(
        port.running_var.numpy() - np.asarray(stats["var"]),
        0.1 * var / (n - 1), atol=1e-6, rtol=1e-4)


def test_calc_metrics_matches_jax():
    rng = np.random.default_rng(4)
    pred = rng.uniform(size=100)
    real = rng.uniform(size=100)
    np.testing.assert_allclose(calc_metrics(pred, real, 125.0),
                               jax_calc_metrics(pred, real, 125.0),
                               rtol=1e-12)


def test_other_methods_raise_naming_roadmap():
    """All 21 methods resolve to their model; an unknown name raises."""
    for name in algorithms._TABLE:
        assert algorithms.get_algorithm_spec(name).model_cls is \
            algorithms.MODELS[name]
    with pytest.raises(NotImplementedError, match="not found"):
        algorithms.get_algorithm_spec("NoSuchMethod")
    assert len(algorithms._TABLE) == len(jalgorithms._TABLE) == 21
    assert set(algorithms._TABLE) == set(jalgorithms._TABLE)


def test_aux_weights_match_jax():
    for name, fields in algorithms._TABLE.items():
        assert fields.get("aux_weight") == \
            jalgorithms._TABLE[name][2].get("aux_weight"), name


class _WithAux(torch.nn.Module):
    """(pred, aux) like the models with an auxiliary loss."""

    def __init__(self):
        super().__init__()
        self.fc = torch.nn.Linear(14 * 50, 1)

    def forward(self, x):
        pred = self.fc(x.reshape(x.shape[0], -1))
        return pred, (pred ** 2).mean()


@pytest.mark.parametrize("aux_weight,weight", [("__one__", 1.0),
                                               ("__zero__", 0.0),
                                               ("theta", 0.001)])
def test_engine_adds_the_weighted_aux_loss(aux_weight, weight):
    x, y = _data(seed=5)
    torch.manual_seed(0)
    engine = Engine(_WithAux(), algorithms.AlgorithmSpec(
        _WithAux, aux_weight=aux_weight), {**TRAIN_PARAMS, "theta": 0.001},
        device="cpu")
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    with torch.no_grad():
        pred, aux = engine.model(xt)
        want = float(mse(pred, yt) + weight * aux)
    assert float(engine.train_step(xt, yt)) == pytest.approx(want, rel=1e-6)
    np.testing.assert_array_equal(engine.evaluate(x).shape, (ROWS,))


def test_trainer_and_engine_raise_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    with pytest.raises(RuntimeError, match="CUDA"):
        Trainer("FC_STGNN", "CMAPSS", "FD001", data=None,
                save_dir=str(tmp_path))
    with pytest.raises(RuntimeError, match="CUDA"):
        Engine(FCSTGNN(**HP), algorithms.get_algorithm_spec("FC_STGNN"),
               TRAIN_PARAMS)
