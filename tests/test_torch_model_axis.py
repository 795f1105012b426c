"""Tensor-parallel parameters over ``--mesh model=M``
(``gnn_rul_tpu_torch/parallel/{mesh,model_axis}.py``) on the CPU, against
the JAX package and the single process, as tests/test_model_axis.py:57-88
and tests/test_parallel.py:24-58 hold the JAX package's.

  - The rule: for every bank key of C-MAPSS, N-CMAPSS, PHM2012 and XJTU-SY
    the port splits as many parameters at ``model=2`` as JAX's
    ``param_sharding_rule`` splits leaves (``jax.eval_shape``, no
    weights), STNet's ChebNet filters among them (their output axis is
    their last: ROADMAP Queue 3 entry 20); each parameter's output axis is
    the one its ``compat`` layout kind names.
  - Two gloo jobs, of 2 ranks (``data=1, model=2``) and 4 (``data=2,
    model=2``), run once for the module (``tests/torch_model_axis_cases.py``)
    at the JAX tests' width of 8 (``TP_MIN_DIM`` set in the ranks, by
    ``monkeypatch`` here): HAGCN, STNet and the hooked HierCorrPool each
    take two steps, every split parameter stored as its 1/M block with
    Adam's moments to match, each step's loss and whole gradient equal to
    the single process's at the job's own weights (rtol 1e-4, atol 1e-5),
    the replicated parameters and buffers bit-identical across the ranks.
    At 2 ranks, a forward that raises leaves the shards in place, STNet's
    steps at bf16 and through ``ShardedTrainer``,
    STFA's gradient at the bank's widths against ``jax.grad`` from the JAX
    package's weights (through ``compat``), and HAGCN's checkpoints through the Trainer: whole tensors under the
    reference's keys, and a resume that lands on the straight run.
"""

import os
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_cases as mesh_cases
import torch_model_axis_cases as cases
from gnn_rul_tpu.configs import hparams as jax_hparams
from gnn_rul_tpu.nn import basic as jax_basic
from gnn_rul_tpu.train.algorithms import get_algorithm_spec as jax_spec
from gnn_rul_tpu_torch.compat import jax_import
from gnn_rul_tpu_torch.configs import hparams as bank
from gnn_rul_tpu_torch.configs.data_configs import get_dataset_config
from gnn_rul_tpu_torch.export import build_model
from gnn_rul_tpu_torch.models import MODELS
from gnn_rul_tpu_torch.parallel import mesh as mesh_lib
from gnn_rul_tpu_torch.parallel._dist_worker import launch, make_bundle
from gnn_rul_tpu_torch.train.trainer import Trainer
from test_torch_model_checks import cell, jax_model, jax_variables

torch.set_num_threads(1)

LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5       # tests/test_model_axis.py:88
GRAD_ATOL, GRAD_RTOL = 1e-5, 1e-4
PRED_ATOL = 1e-4
# bf16: tests/test_torch_bf16.py's loss and gradient-norm tolerances.
BF16_LOSS_RTOL, BF16_GRAD_NORM_RTOL = 2e-3, 0.10
JOB_TIMEOUT = 240
BANK_KEYS = sorted(bank._MODEL, key=str)


def _length(dataset):
    # XJTU-SY windows are served at 32,768 samples (the bank's patches).
    return 32768 if dataset == "XJTU_SY" else \
        get_dataset_config(dataset).sequence_len


def _jax_params(method, dataset, sub_id):
    """The JAX model's parameter shapes at a bank key (abstract)."""
    model = jax_spec(method).model_cls(
        **jax_hparams.model_hparams(dataset, sub_id, method))
    x = jnp.zeros((2, get_dataset_config(dataset).input_channels,
                   _length(dataset)), jnp.float32)
    key = jax.random.PRNGKey(0)
    return jax.eval_shape(lambda: model.init(
        {"params": key, "dropout": key}, x, train=False))["params"]


@pytest.mark.parametrize("dataset,sub_id,method", BANK_KEYS,
                         ids=["-".join(map(str, k)) for k in BANK_KEYS])
def test_split_count_equals_jax(dataset, sub_id, method):
    leaves = jax.tree_util.tree_leaves(_jax_params(method, dataset, sub_id))
    want = sum(leaf.ndim >= 2 and leaf.shape[-1] >= mesh_lib.TP_MIN_DIM
               and leaf.shape[-1] % 2 == 0 for leaf in leaves)
    with torch.device("meta"):
        names = mesh_lib.sharded_params(build_model(method, dataset, sub_id),
                                        2)
    assert len(names) == want, names
    if method == "STNet":   # ROADMAP Queue 3 entry 20
        assert "chebnets.0.filters" in names


# The torch axis that holds the JAX layout's last one, by ``compat``'s
# layout kind: the first of a Linear's, a convolution's and an RNN's
# weight (a transposed raw parameter is a Linear's weight in the port), the
# last of a raw parameter kept as it is.
OUTPUT_AXIS = {"linear": 0, "attention": 0, "conv": 0, "lstm": 0,
               "lstm_reverse": 0, "gru": 0, "param_t": 0, "param": -1}


def _torch_keys(prefix, kind):
    if kind in ("lstm", "lstm_reverse", "gru"):
        sfx = "_reverse" if kind == "lstm_reverse" else ""
        return [f"{prefix}.weight_{w}_l0{sfx}" for w in ("ih", "hh")]
    if kind in ("param", "param_t"):
        return [prefix]
    return [f"{prefix}.weight"]


@pytest.mark.parametrize("method", list(MODELS))
def test_output_axis_is_the_layout_kind(method):
    """Every parameter of two or more axes in ``compat``'s layout of the
    method: the port's output axis is the one its row's kind names."""
    model = build_model(method, *cell(method))
    axes, params = mesh_lib.output_axes(model), dict(model.named_parameters())
    held = set()
    for prefix, kind, _ in jax_import._LAYOUTS[method](
            _jax_params(method, *cell(method))):
        for key in _torch_keys(prefix, kind):
            if key in axes:
                assert axes[key] == (OUTPUT_AXIS[kind]
                                     % params[key].dim()), key
                held.add(key)
    assert held == set(axes)


def test_param_sharding_rule_reads_the_output_axis(monkeypatch):
    class _Mesh:
        mesh_dim_names = ("data", "model")

        def size(self, i):
            return (1, 2)[i]
    rule = mesh_lib.param_sharding_rule(_Mesh())
    assert rule(torch.zeros(3, 9, 300), 2)[1].dim == 2
    assert not rule(torch.zeros(300, 9, 3), 2)[1].is_shard()
    monkeypatch.setattr(mesh_lib, "TP_MIN_DIM", 8)
    assert rule(torch.zeros(3, 9, 16), -1)[1].dim == 2


# ------------------------------------------------------------ the jobs

def _job(out, ranks):
    launch([cases.__file__, str(out)], ranks, JOB_TIMEOUT)
    return torch.load(os.path.join(out, "cases.pt"), weights_only=False)


@pytest.fixture(scope="module")
def stfa_weights():
    """STFA's weights at FD001's widths, the JAX package's own
    initialisation, as the port's state_dict (``compat``)."""
    variables = jax_variables("STFA")
    return variables, jax_import.from_jax_variables("STFA", variables)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory, stfa_weights):
    outs = {k: tmp_path_factory.mktemp(f"model_axis_{k}") for k in (2, 4)}
    torch.save(stfa_weights[1], os.path.join(outs[2], "stfa.pt"))
    with ThreadPoolExecutor(2) as pool:   # the two jobs at once
        done = {k: pool.submit(_job, outs[k], k) for k in (2, 4)}
        return {k: f.result() for k, f in done.items()}


def _hold_grads(got, want, what, atol=GRAD_ATOL, rtol=GRAD_RTOL):
    assert got.keys() == want.keys(), what
    for k in want:
        assert got[k].shape == want[k].shape, (what, k)
        excess = ((got[k] - want[k]).abs()
                  - (atol + rtol * want[k].abs())).max().item()
        assert excess <= 0, (what, k, excess)


JOB_CASES = [(k, m) for k in (2, 4) for m in cases.METHODS]


@pytest.mark.parametrize("ranks,method", JOB_CASES)
def test_steps_equal_the_single_process(jobs, ranks, method, monkeypatch):
    """Each step's global loss and whole gradient against the single
    process's at the job's own weights before the step; the predictions
    after the steps against the single process's run."""
    mesh_cases.lift_fp32_checks(monkeypatch.setattr)
    got = jobs[ranks][method]
    for step, state in enumerate(got["before"]):
        loss, grads = cases.grads_at(method, state, step)
        np.testing.assert_allclose(got["loss"][step], loss, rtol=LOSS_RTOL,
                                   atol=LOSS_ATOL)
        _hold_grads(got["grads"][step], grads, f"{method} step {step}")
    if got["preds"] is not None:
        np.testing.assert_allclose(got["preds"], cases.run(method)["preds"],
                                   atol=PRED_ATOL, rtol=0)


@pytest.mark.parametrize("ranks,method", JOB_CASES)
def test_split_parameters_and_moments_are_blocks(jobs, ranks, method,
                                                 monkeypatch):
    """Every parameter the rule names is stored on each rank as its block
    of 1/2 along its output axis, and so are its two Adam moments; the
    engine counts what it placed; the replicated parameters and buffers
    are the same bits on every rank."""
    monkeypatch.setattr(mesh_lib, "TP_MIN_DIM", cases.TP_MIN_DIM)
    model = MODELS[method](**cases.METHODS[method])
    names = mesh_lib.sharded_params(model, 2)
    axes, params = mesh_lib.output_axes(model), dict(model.named_parameters())
    assert names and jobs[ranks][method]["count"] == len(names)
    views = jobs[ranks]["ranks"]
    assert len(views) == ranks
    for view in views:
        local = view[method]["local"]
        assert sorted(local) == sorted(names)
        for name in names:
            block = list(params[name].shape)
            block[axes[name]] //= 2
            assert local[name] == (tuple(block),) * 3, name
        replicated = view[method]["replicated"]
        assert replicated.keys() == views[0][method]["replicated"].keys()
        for k, v in replicated.items():
            assert torch.equal(v, views[0][method]["replicated"][k]), k


def test_a_forward_that_raises_leaves_the_shards(jobs):
    """Where the model's forward raises after the gathers, every split
    parameter's slot holds its shard again, the leaf Adam steps, and not
    the gathered whole tensor."""
    assert jobs[2]["raised"] is True


def test_bf16_steps_equal_the_single_process(jobs, monkeypatch):
    """STNet's two steps at ``--precision bf16`` on ``data=1, model=2``
    against the single process's bf16 steps at the job's weights."""
    monkeypatch.setattr(mesh_lib, "TP_MIN_DIM", cases.TP_MIN_DIM)
    got = jobs[2]["bf16"]
    assert got["count"] > 0
    for step, state in enumerate(got["before"]):
        loss, grads = cases.grads_at("STNet", state, step, precision="bf16")
        np.testing.assert_allclose(got["loss"][step], loss,
                                   rtol=BF16_LOSS_RTOL)
        assert got["grads"][step].keys() == grads.keys()
        diff = torch.cat([(got["grads"][step][k] - g).reshape(-1)
                          for k, g in grads.items()])
        whole = torch.cat([g.reshape(-1) for g in grads.values()])
        assert diff.norm() <= BF16_GRAD_NORM_RTOL * whole.norm()


def test_sharded_trainer_on_a_model_axis_equals_the_engine(jobs,
                                                           monkeypatch):
    """``ShardedTrainer`` on ``data=1, model=2`` (STNet's wide parameters
    split) against an Engine in one process: the losses, the weights after
    two steps within 5e-4 and the predictions within 1e-4."""
    monkeypatch.setattr(mesh_lib, "TP_MIN_DIM", cases.TP_MIN_DIM)
    (losses, state, preds), (w_losses, w_state, w_preds) = \
        jobs[2]["ShardedTrainer"], cases.sharded_trainer()
    np.testing.assert_allclose(losses, w_losses, rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    assert state.keys() == w_state.keys()
    diff = max((state[k].double() - v.double()).abs().max().item()
               for k, v in w_state.items() if v.is_floating_point())
    assert diff < 5e-4
    np.testing.assert_allclose(preds, w_preds, atol=PRED_ATOL, rtol=0)


def test_stfa_gradient_equals_jax(jobs, stfa_weights, monkeypatch):
    """STFA at FD001's widths on ``data=1, model=2`` (its LSTM's two
    weights split, its attention through the hook) from the JAX package's
    weights: the loss and every gradient against ``jax.grad`` of the JAX
    model's loss, mapped onto the port's keys by ``compat``; dropout off
    on both sides."""
    monkeypatch.setattr(jax_basic.Dropout, "__call__",
                        lambda self, x, train=False: x)
    variables, _ = stfa_weights
    loss, grads, count = jobs[2]["STFA jax"]
    assert count == 2
    x, y = (t.numpy() for t in cases.stfa_batch())
    model = jax_model("STFA")

    def loss_fn(params):
        pred = model.apply({"params": params}, x, train=True,
                           rngs={"dropout": jax.random.PRNGKey(0)})
        pred = pred[0] if isinstance(pred, tuple) else pred
        return jnp.mean((pred - y) ** 2)

    want_loss, want = jax.value_and_grad(loss_fn)(variables["params"])
    np.testing.assert_allclose(loss, float(want_loss), rtol=LOSS_RTOL,
                               atol=LOSS_ATOL)
    want = jax_import.from_jax_variables(
        "STFA", {"params": jax.tree_util.tree_map(np.asarray, want)})
    _hold_grads(grads, want, "STFA against jax.grad")


def test_checkpoint_is_whole_and_resumes_to_the_straight_run(jobs,
                                                             tmp_path):
    """HAGCN's checkpoints from the Trainer on ``data=1, model=2``: rank 0
    writes whole tensors under the reference's keys (the model's and
    Adam's), which load strictly into the unsplit model and evaluate
    through ``Trainer.evaluate_only``; the run resumed after epoch 1 ends
    on the straight run's weights and Adam state, bit for bit."""
    paths = jobs[2]["checkpoints"]
    straight, resumed = (torch.load(paths[k], weights_only=True)
                         for k in ("straight", "resumed"))
    assert straight["epoch"] == resumed["epoch"] == 2
    model = MODELS[cases.CKPT_METHOD](**cases.METHODS[cases.CKPT_METHOD])
    want = model.state_dict()
    assert straight["model_dict"].keys() == want.keys()
    for k, v in want.items():
        assert straight["model_dict"][k].shape == v.shape, k
        assert torch.equal(straight["model_dict"][k],
                           resumed["model_dict"][k]), k
    params = list(model.parameters())
    for i, state in straight["optimizer"]["state"].items():
        for key in ("exp_avg", "exp_avg_sq"):
            assert state[key].shape == params[i].shape
            assert torch.equal(state[key],
                               resumed["optimizer"]["state"][i][key])
    model.load_state_dict(straight["model_dict"], strict=True)
    best = Trainer(cases.CKPT_METHOD, "CMAPSS", "FD001", make_bundle(),
                   save_dir=str(tmp_path), device="cpu",
                   model_hparams=cases.METHODS[cases.CKPT_METHOD],
                   ).evaluate_only(straight["model_dict"])
    assert np.all(np.isfinite(best[None]))

