"""Edge accounting in the port (gnn_rul_tpu_torch.ops.edge_count) against
the JAX package's (gnn_rul_tpu.ops.edge_count) on the CPU: edges per
sample of every method at the bank's hparams, counted on the meta device
with no kernel launched, and the sequential trainer's edges/s."""

import os
import re

import numpy as np
import pytest
import torch

from gnn_rul_tpu.ops import edge_count as jax_edge_count
from gnn_rul_tpu_torch import cli
from gnn_rul_tpu_torch.export import build_model
from gnn_rul_tpu_torch.models import MODELS
from gnn_rul_tpu_torch.ops import edge_count
from gnn_rul_tpu_torch.ops.kernels import WRAPPERS
from test_torch_cli import _write_fd001
from test_torch_model_checks import cell, input_shape, jax_model

torch.set_num_threads(1)


def _launches():
    return {k: (w.launches, getattr(w, "bwd_launches", 0))
            for k, w in WRAPPERS.items()}


@pytest.mark.parametrize("method", list(MODELS))
def test_edges_per_sample_matches_jax(method):
    """The same integer as the JAX package's abstract trace, from one train
    forward on the meta device: no kernel launches, the model untouched."""
    x = np.zeros((2, *input_shape(method)), np.float32)
    want = jax_edge_count.edges_per_sample(jax_model(method), x)
    model = build_model(method, *cell(method)).eval()
    before = _launches()
    got = edge_count.edges_per_sample(model, x)
    assert isinstance(got, int) and got == want > 0
    assert _launches() == before
    assert not model.training
    assert all(p.device.type == "cpu" for p in model.parameters())


def test_edges_per_sample_draws_no_random_numbers():
    model = build_model("FC_STGNN", "CMAPSS", "FD001")
    torch.manual_seed(0)
    state = torch.get_rng_state()
    edge_count.edges_per_sample(model, np.zeros((2, 14, 50), np.float32))
    assert torch.equal(torch.get_rng_state(), state)


def test_record_edges_counts_only_inside_count_edges():
    edge_count.record_edges((3, 4, 4))  # no active counter: nothing
    with edge_count.count_edges() as outer:
        edge_count.record_edges((2, 5, 5))
        with edge_count.count_edges() as inner:
            edge_count.record_edges((7, 7))
        edge_count.record_edges(torch.Size([1, 3, 3]))
    assert (outer[0], inner[0]) == (59, 49)
    edge_count.record_edges((3, 4, 4))
    assert outer[0] == 59


def test_trainer_logs_edges_per_sample_and_edges_per_second(tmp_path,
                                                            monkeypatch):
    """The sequential trainer logs the run's edges per sample once, and
    each epoch's samples/s and edges/s, their ratio that count."""
    from gnn_rul_tpu_torch.configs import hparams as bank
    root = str(tmp_path)
    data_root = _write_fd001(root, n_train=20, n_test=6)
    orig = bank.train_params
    monkeypatch.setattr(bank, "train_params", lambda *a: {
        **orig(*a), "batch_size": 8})
    cli.main(["--GNN_method", "FC_STGNN", "--dataset", "CMAPSS",
              "--dataset_id", "FD001", "--data_path", data_root,
              "--save_dir", os.path.join(root, "logs"), "--device", "cpu",
              "--epochs", "2", "--num_runs", "1"])
    log = open(os.path.join(root, "logs", "GNN_RUL", "run_1",
                            "FC_STGNN_run_0", "logs_run_0.log")).read()
    edges = [int(v) for v in re.findall(r"Edges per sample: (\d+)", log)]
    assert edges == [edge_count.edges_per_sample(
        build_model("FC_STGNN", "CMAPSS", "FD001"),
        np.zeros((2, 14, 50), np.float32))] == [1568]
    rates = re.findall(r"\| ([\d,]+) samples/s \| ([\d.e+]+) edges/s\)", log)
    assert len(rates) == 2
    for sps, eps in rates:
        sps = float(sps.replace(",", ""))
        assert float(eps) == pytest.approx(1568 * sps, rel=6e-3, abs=1568)
