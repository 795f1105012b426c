"""The port's LOGO_bearing (gnn_rul_tpu_torch/models/logo_bearing.py) and
the per-batch MultiStepLR it trains with (gnn_rul_tpu_torch/train/
engine.py) against the JAX package's on the CPU, at PHM2012/Condition_1
full width, windows of (1, 2560), by the shared checks of
tests/test_torch_model_checks.py: the eval forward, the weight round trip,
the symbolic-batch artifact (3 ``lstm_recurrence`` nodes), the train-mode
graph regularization loss, 7 Adam steps across the first milestone
(tests/test_parity_aux_losses.py::
test_logo_bearing_per_batch_multistep_trajectory), the lr of 30 steps
against ``multistep_lr_schedule`` exactly, the padded evaluation; the
forward at XJTU_SY/Condition_1 on the raw minute of 32,768 samples, and
its serving there through ``seq_len``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.optim.optimizer import register_optimizer_step_pre_hook

from gnn_rul_tpu.nn import basic as jax_basic
from gnn_rul_tpu.train import algorithms as jalgorithms
from gnn_rul_tpu.train import engine as jengine
from gnn_rul_tpu_torch import export
from gnn_rul_tpu_torch.models import MODELS
from gnn_rul_tpu_torch.train import algorithms
from gnn_rul_tpu_torch.train.engine import Engine

import test_torch_model_checks as checks

METHOD = "LOGO_bearing"
STEPS = 7  # across the first milestone, 5


@pytest.fixture(scope="module")
def variables():
    return checks.jax_variables(METHOD)


@pytest.mark.parametrize("rows", [2, 4])
def test_eval_output_matches_jax(variables, rows):
    assert checks.check_eval_forward(METHOD, variables, rows,
                                     seed=rows) == 0


def test_weight_carry_round_trips_exactly(variables):
    """LOGO's keys: the JAX tree sits under ``core``."""
    checks.check_round_trip(METHOD, variables)
    assert list(variables["params"]) == ["core"]


def test_symbolic_artifact_matches_live_model(variables, tmp_path):
    """The recurrence runs along the batch: T is the symbolic batch at each
    of the 3 Bi-LSTM layers' operator calls."""
    program = checks.check_symbolic_artifact(METHOD, variables, tmp_path)
    assert checks.op_nodes(program, "lstm_recurrence") == 3
    assert checks.our_op_nodes(program) == 3


def test_train_mode_gl_loss_matches_jax(variables, monkeypatch):
    monkeypatch.setattr(jax_basic.Dropout, "__call__",
                        lambda self, x, train=False: x)
    x = checks.x_rows(4, seed=0, method=METHOD)
    want_pred, want_gl = checks.jax_model(METHOD).apply(
        variables, jnp.asarray(x), train=True,
        rngs={"dropout": jax.random.PRNGKey(0)})
    model = checks.no_dropout(checks.port_model(METHOD, variables)).train()
    with torch.no_grad():
        got_pred, got_gl = model(torch.from_numpy(x))
    np.testing.assert_allclose(float(got_gl), float(want_gl),
                               rtol=checks.FWD_RTOL)
    np.testing.assert_allclose(got_pred.numpy(), np.asarray(want_pred),
                               atol=checks.FWD_ATOL, rtol=checks.FWD_RTOL)


def test_seven_adam_steps_match_jax_across_a_milestone(monkeypatch):
    """Dropout (the Bi-LSTM's 0.2) off on both sides, the GL loss at
    theta = 0.001 on both. Both engines step the per-batch MultiStepLR:
    steps 6 and 7 run at half the lr, which moves each parameter by up to
    5e-4 less than a constant lr would, past PARAM_MAX_DIFF."""
    assert checks.TRAIN_PARAMS["theta"] == 0.001
    assert jalgorithms.get_algorithm_spec(METHOD).per_batch_multistep
    lrs = []  # the lr of every torch optimizer step from here
    handle = register_optimizer_step_pre_hook(
        lambda opt, args, kwargs: lrs.append(opt.param_groups[0]["lr"]))
    try:
        loss_ref, param_ref, _ = checks.check_trajectory(METHOD, monkeypatch,
                                                         steps=STEPS)
    finally:
        handle.remove()
    assert (loss_ref, param_ref) == ("jax", "jax")
    assert lrs == [1e-3] * 5 + [5e-4] * 2


def test_lr_of_thirty_steps_is_the_jax_schedule_exactly():
    """A 30-step run, 3 steps an epoch over 10 epochs: the lr of optimizer
    step t is ``multistep_lr_schedule(lr)(t)``, the same float32, across
    the epochs; a second engine, as the trainer builds for its next run,
    starts again at t = 0. Only LOGO_bearing's spec steps a scheduler."""
    lr = 1e-3
    spec = algorithms.get_algorithm_spec(METHOD)
    schedule = jengine.multistep_lr_schedule(lr)
    want = [np.asarray(schedule(jnp.asarray(t, jnp.int32)))
            for t in range(30)]
    assert want[-1] == np.float32(lr * 0.5 ** 4)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(9, 3)).astype(np.float32)
    y = rng.normal(size=(9, 1)).astype(np.float32)
    params = {"learning_rate": lr, "weight_decay": 0.0, "batch_size": 3,
              "theta": 0.001}
    for run in range(2):
        engine = Engine(torch.nn.Linear(3, 1), spec, params, device="cpu")
        lrs = []
        engine.optimizer.register_step_pre_hook(
            lambda opt, args, kwargs: lrs.append(opt.param_groups[0]["lr"]))
        for epoch in range(1, 11):
            engine.run_epoch(x, y, epoch, shuffle=True)
        assert len(lrs) == 30
        assert [np.float32(v) for v in lrs] == want, run
        assert lrs[-1] == lr * 0.5 ** 4
    other = Engine(torch.nn.Linear(3, 1), algorithms.get_algorithm_spec(
        "LOGO"), params, device="cpu")
    assert other.scheduler is None
    assert [m for m in algorithms._TABLE
            if algorithms.get_algorithm_spec(m).per_batch_multistep] == [
        METHOD]


def test_evaluate_pads_like_jax_and_padding_reaches_real_rows(variables):
    """Six windows at an eval batch of 4: the last forward holds two real
    rows and two copies of the last. Both engines pad alike and agree; the
    batch-axis recurrence carries the padding into the real rows' answers,
    as in the JAX package, so the padded answers differ from one forward
    over all six rows."""
    x = checks.x_rows(6, seed=1, method=METHOD)
    jax_engine = jengine.Engine(checks.jax_model(METHOD),
                                jalgorithms.get_algorithm_spec(METHOD),
                                checks.TRAIN_PARAMS, seed=2,
                                eval_batch_size=4)
    state = jax_engine.init_state(x)
    port = Engine(checks.port_model(METHOD, {"params": checks.numpy_tree(
        state.params)}), algorithms.get_algorithm_spec(METHOD),
                  checks.TRAIN_PARAMS, eval_batch_size=4, device="cpu")
    got = port.evaluate(x)
    assert got.shape == (6,) and got.dtype == np.float32
    np.testing.assert_allclose(got, jax_engine.evaluate(state, x),
                               atol=checks.FWD_ATOL, rtol=checks.FWD_RTOL)
    with torch.no_grad():
        whole = port.model(torch.from_numpy(x)).reshape(-1).numpy()
    assert np.abs(got - whole).max() > 1e-6


def test_logo_bearing_at_xjtu_sy_full_minute():
    """BASELINE.md tier 5's configuration: 32 patches of 1024, 17 bins of
    33 frames, so the Bi-LSTM's batch is 17 x 32 = 544 node-patches."""
    checks.check_cell_forward(METHOD, "XJTU_SY", "Condition_1", rows=2,
                              seed=3, length=32768)


def test_serving_takes_the_raw_length_through_seq_len():
    torch.manual_seed(0)
    model = export.build_model(METHOD, "XJTU_SY", "Condition_1")
    served = export.serving_model(METHOD, "XJTU_SY", "Condition_1",
                                  model.state_dict(), seq_len=32768,
                                  device="cpu")
    assert served.meta["input_shape"] == [None, 1, 32768]
    x = np.random.default_rng(0).uniform(size=(3, 1, 32768)).astype(
        np.float32)
    with torch.no_grad():
        want = model.eval()(torch.from_numpy(x)).reshape(-1).numpy()
    np.testing.assert_array_equal(served(x), want)


@pytest.mark.parametrize("field", ["num_nodes", "input_dim"])
def test_refuses_widths_off_the_stft(field):
    kwargs = checks.hp(METHOD)
    with pytest.raises(ValueError, match="bins"):
        MODELS[METHOD](**{**kwargs, field: kwargs[field] + 1})
