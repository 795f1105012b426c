"""The port's utilities (``gnn_rul_tpu_torch/utils.py``) and ``--profile``
on the CPU, against the JAX package's ``gnn_rul_tpu/utils.py``:
AverageMeter, the parameter count of all 21 methods, the operation count
(a hand count for a Linear and a Conv1d, and the three operators' counts
inside FC_STGNN's, LOGO's and STAGNN's), ``prng_seq``, ``device_sync``,
``debug_nans``, and the CLI's ``--profile`` trace (of epoch 2, naming the
port's operator and its ``train.step`` spans; none after one epoch), with
``--vectorized_runs`` too."""

import glob
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn
from torch.utils.flop_counter import FlopCounterMode

from gnn_rul_tpu import utils as jax_utils
from gnn_rul_tpu.configs import hparams as jax_hparams
from gnn_rul_tpu.train.algorithms import get_algorithm_spec as jax_spec
from gnn_rul_tpu_torch import cli, utils
from gnn_rul_tpu_torch.configs import hparams as bank
from gnn_rul_tpu_torch.configs.data_configs import get_dataset_config
from gnn_rul_tpu_torch.export import build_model
from gnn_rul_tpu_torch.models import MODELS
from test_torch_cli import _write_fd001
from test_torch_model_checks import cell

torch.set_num_threads(1)


def test_average_meter_matches_jax():
    ours, theirs = utils.AverageMeter(), jax_utils.AverageMeter()
    for val, n in ((1.5, 2), (4.0, 1), (-2.0, 5)):
        ours.update(val, n)
        theirs.update(val, n)
    assert (ours.val, ours.sum, ours.count, ours.avg) == \
        (theirs.val, theirs.sum, theirs.count, theirs.avg)
    ours.reset()
    assert (ours.val, ours.sum, ours.count, ours.avg) == (0.0, 0.0, 0, 0.0)


@pytest.mark.parametrize("method", list(MODELS))
def test_param_count_equals_jax(method):
    """Every method at its cell's bank widths: the port's parameter count
    against the JAX package's ``param_count`` of its flax parameters
    (abstract, ``jax.eval_shape``: nothing is computed)."""
    dataset, sub_id = cell(method)
    cfg = get_dataset_config(dataset)
    model = jax_spec(method).model_cls(
        **jax_hparams.model_hparams(dataset, sub_id, method))
    x = jnp.zeros((2, cfg.input_channels, cfg.sequence_len), jnp.float32)
    key = jax.random.PRNGKey(0)
    variables = jax.eval_shape(
        lambda: model.init({"params": key, "dropout": key}, x, train=False))
    assert utils.param_count(build_model(method, dataset, sub_id)) == \
        jax_utils.param_count(variables["params"])


def test_complexity_of_a_linear_and_a_conv_by_hand():
    """torch's convention, 2 operations a multiply-add: the convolution's
    2 * 4 out x 16 steps x 3 in x 5 taps, the Linear's 2 * 64 x 2."""
    model = nn.Sequential(nn.Conv1d(3, 4, 5), nn.Flatten(), nn.Linear(64, 2))
    flops, params = utils.complexity_computation(model, 3, 20)
    assert flops == 2 * 4 * 16 * 3 * 5 + 2 * 64 * 2
    assert params == (4 * 3 * 5 + 4) + (64 * 2 + 2)


@pytest.mark.parametrize("method,op", [
    ("FC_STGNN", "fused_dot_graph_spmm"), ("LOGO", "lstm_recurrence"),
    ("STAGNN", "fused_gat")])
def test_complexity_counts_the_operators(method, op):
    """The eval forward's count includes each operator's registered count
    (the bounds' operations), read here from the counter's table."""
    model = build_model(method, "CMAPSS", "FD001").eval()
    counter = FlopCounterMode(display=False)
    with torch.no_grad(), counter:
        model(torch.zeros(1, 14, 50))
    packet = getattr(torch.ops.gnn_rul_tpu_torch, op)
    ours = counter.get_flop_counts()["Global"].get(packet, 0)
    assert ours > 0
    flops, params = utils.complexity_computation(model, 14, 50)
    assert flops == counter.get_total_flops() and flops > ours
    assert params == utils.param_count(model)


def test_operator_counts_match_the_bounds_formulas():
    """The registered counts are chip_smoke.py's bound operations."""
    assert utils._dot_graph_flops((3, 28, 16), (3, 28, 16), (28, 28)) == \
        2 * 3 * 28 * 28 * (16 + 16)
    assert utils._gat_flops((5, 14, 64), (5, 14), (5, 14), (14, 14), (),
                            0.1) == 2 * 5 * 14 * 14 * 64 + 6 * 5 * 14 * 14
    h, t, b = 48, 70, 100
    assert utils._lstm_flops((t, 2, b, 4 * h), (2, h, 4 * h)) == \
        t * 2 * b * (8 * h * h + 14 * h)


def test_prng_seq_is_deterministic():
    a, b, c = utils.prng_seq(3), utils.prng_seq(3), utils.prng_seq(4)
    first = [next(a) for _ in range(5)]
    assert first == [next(b) for _ in range(5)]
    assert len(set(first)) == 5
    assert first != [next(c) for _ in range(5)]
    g1, g2 = (next(utils.prng_seq(3, generators=True)) for _ in range(2))
    assert torch.equal(torch.randn(4, generator=g1),
                       torch.randn(4, generator=g2))


def test_seed_everything_and_device_sync():
    utils.seed_everything(5)
    a = (np.random.rand(), torch.rand(1).item())
    utils.seed_everything(5)
    assert a == (np.random.rand(), torch.rand(1).item())
    assert utils.device_sync(torch.tensor([[2.5, 1.0]])) == 2.5


def test_debug_nans_raises_at_the_operation():
    x = torch.tensor([-1.0], requires_grad=True)
    with pytest.raises(RuntimeError, match="nan|NaN"):
        with utils.debug_nans():
            torch.sqrt(x).sum().backward()


def _profile_trace_text(tmp_path, monkeypatch, epochs, *flags):
    """The text of the trace ``--profile`` writes for FC_STGNN's run of
    ``epochs``, or None where it writes none."""
    orig = bank.train_params
    monkeypatch.setattr(bank, "train_params", lambda *a: {
        **orig(*a), "batch_size": 16})
    data_root = _write_fd001(str(tmp_path), n_train=20, n_test=4)
    trace = tmp_path / "trace"
    cli.main(["--GNN_method", "FC_STGNN", "--data_path", data_root,
              "--save_dir", str(tmp_path / "logs"), "--device", "cpu",
              "--epochs", str(epochs), "--profile", str(trace), *flags])
    files = glob.glob(os.path.join(trace, "*.pt.trace.json"))
    assert len(files) <= 1
    return open(files[0]).read() if files else None


@pytest.mark.parametrize("epochs,traced", [(2, True), (1, False)])
def test_cli_profile_traces_the_second_epoch(tmp_path, monkeypatch, epochs,
                                             traced):
    text = _profile_trace_text(tmp_path, monkeypatch, epochs)
    assert (text is not None) == traced
    if traced:
        assert "gnn_rul_tpu_torch::fused_dot_graph_spmm" in text
        assert '"train.step"' in text and "Input Dims" in text


@pytest.mark.parametrize("epochs,traced", [(2, True), (1, False)])
def test_cli_profile_traces_the_second_epoch_of_vectorized_runs(
        tmp_path, monkeypatch, epochs, traced):
    """As the per-run path, the steps' spans in it, and no input shapes:
    under vmap recording them keeps every batched input alive until the
    profiler stops."""
    text = _profile_trace_text(tmp_path, monkeypatch, epochs, "--num_runs",
                               "2", "--vectorized_runs")
    assert (text is not None) == traced
    if traced:
        assert "gnn_rul_tpu_torch::fused_dot_graph_spmm" in text
        assert '"train.step"' in text and "Input Dims" not in text
