"""The port's CLI end to end on the CPU: a synthetic processed FD001 ->
cli.main -> results.csv, results.npz and a checkpoint.pt that both the
port's serving entry point and the JAX package's importer load."""

import csv
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_rul_tpu import cli as jax_cli
from gnn_rul_tpu.compat import import_torch_checkpoint
from gnn_rul_tpu.models.fc_stgnn import FCSTGNN as JaxFCSTGNN
from gnn_rul_tpu_torch import cli
from gnn_rul_tpu_torch.configs import hparams as bank
from gnn_rul_tpu_torch.data.io import save_processed
from gnn_rul_tpu_torch.data.loader import load_dataset
from gnn_rul_tpu_torch.export import build_model, serving_model
from gnn_rul_tpu_torch.train.algorithms import get_algorithm_spec
from gnn_rul_tpu_torch.train.checkpoint import save_checkpoint
from gnn_rul_tpu_torch.train.engine import Engine
from gnn_rul_tpu_torch.train.metrics import calc_metrics

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
    ["--profile", "trace"], ["--fused", "off"]])
def test_unported_flags_raise_naming_roadmap(tmp_path, flags):
    with pytest.raises(NotImplementedError, match="ROADMAP.md"):
        cli.main(["--device", "cpu", "--data_path", str(tmp_path)] + flags)


def _seeded_checkpoint(path, method, seed=0):
    """A port checkpoint.pt of ``method``/FD001 with seeded weights, as the
    trainer writes it."""
    torch.manual_seed(seed)
    model = build_model(method, "CMAPSS", "FD001")
    save_checkpoint(path, model, torch.optim.Adam(model.parameters()),
                    epoch=1, run_id=0,
                    hparams=bank.model_hparams("CMAPSS", "FD001", method),
                    train_params=bank.train_params("CMAPSS", "FD001", method))
    return model


def _eval_args(data_root, save_dir, method, checkpoint):
    return ["--GNN_method", method, "--dataset", "CMAPSS", "--dataset_id",
            "FD001", "--data_path", data_root, "--save_dir", save_dir,
            "--eval_torch_checkpoint", checkpoint]


@pytest.mark.parametrize("layout", ["checkpoint", "model_prefixed",
                                    "state_dict"])
def test_cli_eval_torch_checkpoint_evaluates_the_weights(tmp_path, layout):
    """--eval_torch_checkpoint on a port checkpoint.pt, on a model_dict
    whose keys carry the algorithm's "model." prefix, and on a bare
    state_dict: the test set's metrics of those weights, written under
    <method>_eval, and no training run."""
    root = str(tmp_path)
    data_root = _write_fd001(root)
    path = os.path.join(root, "checkpoint.pt")
    model = _seeded_checkpoint(path, "STGNN")
    if layout != "checkpoint":
        sd = model.state_dict()
        if layout == "model_prefixed":
            torch.save({"model_dict": {f"model.{k}": v
                                       for k, v in sd.items()}}, path)
        else:
            torch.save(sd, path)
    save_dir = os.path.join(root, "logs")
    results = cli.main(_eval_args(data_root, save_dir, "STGNN", path)
                       + ["--device", "cpu"])

    data = load_dataset(os.path.join(data_root, "CMAPSS", "FD001"))
    engine = Engine(model, get_algorithm_spec("STGNN"),
                    bank.train_params("CMAPSS", "FD001", "STGNN"),
                    device="cpu")
    tx, ty = data.test
    want = calc_metrics(engine.evaluate(tx), ty.reshape(-1), data.max_ruls)
    np.testing.assert_allclose(results[None], want, rtol=1e-6)
    run_dir = os.path.join(save_dir, "GNN_RUL", "run_1")
    assert os.listdir(run_dir) == ["STGNN_eval"]
    with open(os.path.join(run_dir, "STGNN_eval", "results.csv")) as f:
        rows = list(csv.reader(f))
    assert rows[0] == ["Score_v1", "Score_v2", "MAE", "RMSE"]
    np.testing.assert_allclose([float(v) for v in rows[1]], want, rtol=1e-6)
    npz = np.load(os.path.join(run_dir, "STGNN_eval", "results.npz"))
    assert npz["pre"].shape == (10,)


@pytest.mark.parametrize("method", ["GRU_CM", "HAGCN", "HierCorrPool"])
def test_eval_torch_checkpoint_matches_jax_evaluate_only(tmp_path, method):
    """The port's --eval_torch_checkpoint and the JAX package's (its
    Trainer.evaluate_only on import_torch_checkpoint) on the same port
    checkpoint.pt and test set: the predictions in results.npz at the
    forward's parity tolerance, the metrics at its rtol (Score_v1 is
    exponential in the error, 1e31 for these untrained weights on random
    windows)."""
    root = str(tmp_path)
    data_root = _write_fd001(root)
    path = os.path.join(root, "checkpoint.pt")
    _seeded_checkpoint(path, method, seed=1)
    got = cli.main(_eval_args(data_root, os.path.join(root, "port"), method,
                              path) + ["--device", "cpu"])
    want = jax_cli.main(_eval_args(data_root, os.path.join(root, "jax"),
                                   method, path))
    assert set(got) == set(want) == {None}
    preds = [np.load(os.path.join(root, side, "GNN_RUL", "run_1",
                                  f"{method}_eval", "results.npz"))["pre"]
             for side in ("port", "jax")]
    np.testing.assert_allclose(*preds, atol=2e-4, rtol=1e-4)
    np.testing.assert_allclose(got[None], want[None], rtol=1e-4)
