"""The port's CLI end to end on the CPU: a synthetic processed FD001 ->
cli.main -> results.csv, results.npz and a checkpoint.pt that both the
port's serving entry point and the JAX package's importer load."""

import csv
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_rul_tpu.compat import import_torch_checkpoint
from gnn_rul_tpu.models.fc_stgnn import FCSTGNN as JaxFCSTGNN
from gnn_rul_tpu_torch import cli
from gnn_rul_tpu_torch.configs import hparams as bank
from gnn_rul_tpu_torch.data.io import save_processed
from gnn_rul_tpu_torch.export import serving_model

torch.set_num_threads(1)


def _write_fd001(root, n_train=40, n_test=10, seed=0):
    rng = np.random.default_rng(seed)
    data_dir = os.path.join(root, "Processed_dataset", "CMAPSS", "FD001")
    # Samples in the preprocessor's layout (N, seq_len, channels).
    save_processed(data_dir, "train",
                   rng.normal(size=(n_train, 50, 14)).astype(np.float32),
                   rng.uniform(size=(n_train, 1)).astype(np.float32), 125)
    save_processed(data_dir, "test",
                   rng.normal(size=(n_test, 50, 14)).astype(np.float32),
                   rng.uniform(size=(n_test, 1)).astype(np.float32), 125)
    return os.path.join(root, "Processed_dataset")


def test_cli_trains_and_its_checkpoint_serves(tmp_path, monkeypatch):
    root = str(tmp_path)
    data_root = _write_fd001(root)
    orig = bank.train_params

    def small_batch(dataset, sub_id, method):
        return {**orig(dataset, sub_id, method), "batch_size": 16}

    monkeypatch.setattr(bank, "train_params", small_batch)
    results = cli.main([
        "--GNN_method", "FC_STGNN", "--dataset", "CMAPSS",
        "--dataset_id", "FD001", "--data_path", data_root,
        "--save_dir", os.path.join(root, "logs"), "--device", "cpu",
        "--epochs", "1", "--num_runs", "1"])

    best = results[0][None]
    assert len(best) == 4 and all(np.isfinite(v) for v in best)
    run_dir = os.path.join(root, "logs", "GNN_RUL", "run_1", "FC_STGNN_run_0")
    with open(os.path.join(run_dir, "results.csv")) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["Score_v1", "Score_v2", "MAE", "RMSE"]
    assert len(rows) == 2 and np.allclose([float(v) for v in rows[1]], best)
    npz = np.load(os.path.join(run_dir, "results.npz"))
    assert npz["pre"].shape == npz["real"].shape == (10,)
    assert float(npz["max_rul"]) == 125
    assert os.path.exists(os.path.join(run_dir, "logs_run_0.log"))

    path = os.path.join(run_dir, "checkpoint.pt")
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    assert set(ckpt) == {"hparams", "train_params", "model_dict",
                         "optimizer", "epoch", "run_id"}
    assert ckpt["epoch"] == 1 and ckpt["train_params"]["batch_size"] == 16
    x = np.random.default_rng(5).normal(size=(7, 14, 50)).astype(np.float32)
    got = serving_model("FC_STGNN", "CMAPSS", "FD001", ckpt["model_dict"],
                        device="cpu")(x)
    variables = import_torch_checkpoint(path, "FC_STGNN", dataset="CMAPSS",
                                        dataset_id="FD001")
    want = np.asarray(JaxFCSTGNN(**ckpt["hparams"], fused="off").apply(
        variables, jnp.asarray(x), train=False)).reshape(-1)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_cli_raises_without_cuda(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(["--data_path", str(tmp_path)])


@pytest.mark.parametrize("flags", [
    ["--mesh", "data=2,model=1"], ["--precision", "bf16"],
    ["--vectorized_runs"], ["--resume"], ["--checkpoint_every", "5"],
    ["--profile", "trace"], ["--eval_torch_checkpoint", "checkpoint.pt"],
    ["--fused", "off"]])
def test_unported_flags_raise_naming_roadmap(tmp_path, flags):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        cli.main(["--device", "cpu", "--data_path", str(tmp_path)] + flags)
