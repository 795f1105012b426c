"""Resumable checkpoints in the port (gnn_rul_tpu_torch.train.checkpoint,
the Trainer's and the CLI's --checkpoint_every and --resume) on the CPU:
the AsyncCheckpointer's contract (mirrors tests/test_checkpoint_async.py:
round trip, ordered saves, a save that does not wait for a slow writer,
an atomic write, a writer's error re-raised), a snapshot that the
optimizer step after it does not reach, resume (mirrors
tests/test_trainer_e2e.py:64-111), an interrupted and resumed run equal
to the straight run with dropout on (FC_STGNN's PE dropout, LOGO_bearing's
trunk dropout across its MultiStepLR's milestone 10), and a resumed
checkpoint read by the JAX package's import_torch_checkpoint."""

import os
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gnn_rul_tpu.compat import import_torch_checkpoint
from gnn_rul_tpu.configs import hparams as jax_hparams
from gnn_rul_tpu.train import algorithms as jalgorithms
from gnn_rul_tpu_torch import cli
from gnn_rul_tpu_torch.configs import hparams as bank
from gnn_rul_tpu_torch.data.loader import DataBundle
from gnn_rul_tpu_torch.export import build_model, serving_model
from gnn_rul_tpu_torch.train import checkpoint as ck
from gnn_rul_tpu_torch.train.algorithms import get_algorithm_spec
from gnn_rul_tpu_torch.train.checkpoint import (AsyncCheckpointer,
                                                load_checkpoint, restore,
                                                save_checkpoint)
from gnn_rul_tpu_torch.train.engine import Engine
from gnn_rul_tpu_torch.train.trainer import Trainer
from test_torch_cli import _write_fd001
from test_torch_model_checks import x_rows

torch.set_num_threads(1)

TP = {"num_epochs": 2, "batch_size": 16, "weight_decay": 1e-4,
      "learning_rate": 1e-3}


def _bundle(n_train=40, n_test=10, method="FC_STGNN"):
    rng = np.random.default_rng(0)
    tx = x_rows(n_train, 1, method)
    ex = x_rows(n_test, 2, method)
    return DataBundle(tx, rng.uniform(size=(n_train, 1)).astype(np.float32),
                      (ex, rng.uniform(size=(n_test, 1)).astype(np.float32)),
                      125.0)


def _engine(method="FC_STGNN", seed=0):
    torch.manual_seed(seed)
    return Engine(build_model(method, "CMAPSS", "FD001"),
                  get_algorithm_spec(method), TP, seed=seed, device="cpu")


def _save(ckptr_or_fn, path, engine, epoch):
    return ckptr_or_fn(path, engine.model, engine.optimizer, epoch=epoch,
                       run_id=0, hparams={}, train_params=TP,
                       scheduler=engine.scheduler)


def _step(engine, seed=0):
    rng = np.random.default_rng(seed)
    engine.train_step(torch.from_numpy(x_rows(8, seed)),
                      torch.from_numpy(rng.uniform(size=(8, 1)).astype(
                          np.float32)))


def _same_state(a, b):
    return all(torch.equal(a[k], b[k]) for k in a) and set(a) == set(b)


# ------------------------------------------------------ AsyncCheckpointer


def test_async_save_restore_roundtrip(tmp_path):
    path = str(tmp_path / "checkpoint.pt")
    engine = _engine()
    _step(engine)
    ckptr = AsyncCheckpointer()
    _save(ckptr.save, path, engine, 3)
    ckptr.close()
    payload = torch.load(path, weights_only=True)
    assert set(payload) == {"hparams", "train_params", "model_dict",
                            "optimizer", "epoch", "run_id", "scheduler",
                            "precision"}
    assert payload["epoch"] == 3 and payload["precision"] == "fp32"
    fresh = _engine(seed=5)
    assert restore(path, fresh.model, fresh.optimizer) == 3
    assert _same_state(fresh.model.state_dict(), engine.model.state_dict())
    for a, b in zip(fresh.optimizer.state_dict()["state"].values(),
                    engine.optimizer.state_dict()["state"].values()):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert load_checkpoint(path)[0].keys() == engine.model.state_dict().keys()


def test_async_saves_serialize_in_order(tmp_path):
    """Back-to-back saves land in order; the last write wins."""
    path = str(tmp_path / "checkpoint.pt")
    engine = _engine()
    ckptr = AsyncCheckpointer()
    for epoch in (1, 2, 3):
        _step(engine, seed=epoch)
        _save(ckptr.save, path, engine, epoch)
    ckptr.close()
    payload = torch.load(path, weights_only=True)
    assert payload["epoch"] == 3
    assert _same_state(payload["model_dict"], engine.model.state_dict())


def test_async_save_does_not_block_caller(tmp_path, monkeypatch):
    """save() returns before the write ends: the training thread never
    waits on the disk. Proven with a slow writer."""
    started = threading.Event()
    orig = ck._write

    def slow_write(path, payload):
        started.set()
        time.sleep(0.5)
        return orig(path, payload)

    monkeypatch.setattr(ck, "_write", slow_write)
    path = str(tmp_path / "checkpoint.pt")
    engine = _engine()
    ckptr = AsyncCheckpointer()
    t0 = time.time()
    _save(ckptr.save, path, engine, 1)
    assert time.time() - t0 < 0.2
    assert started.wait(timeout=5.0)
    assert not os.path.exists(path)
    ckptr.close()
    assert os.path.exists(path)


def test_atomic_write_never_corrupts_previous(tmp_path, monkeypatch):
    """A crash mid-write leaves the previous checkpoint intact (a temporary
    file, then os.replace); AsyncCheckpointer.wait re-raises the writer's
    error."""
    path = str(tmp_path / "checkpoint.pt")
    engine = _engine()
    _save(save_checkpoint, path, engine, 1)

    def boom(*a, **k):
        raise RuntimeError("disk full")

    monkeypatch.setattr(torch, "save", boom)
    with pytest.raises(RuntimeError, match="disk full"):
        _save(save_checkpoint, path, engine, 2)
    ckptr = AsyncCheckpointer()
    _save(ckptr.save, path, engine, 3)
    with pytest.raises(RuntimeError, match="disk full"):
        ckptr.wait()
    ckptr.close()
    monkeypatch.undo()
    assert torch.load(path, weights_only=True)["epoch"] == 1


def test_snapshot_is_not_reached_by_the_next_step(tmp_path):
    """The step after a save rewrites the weights and Adam's moments in
    place; the file holds them as they were at the save."""
    path = str(tmp_path / "checkpoint.pt")
    engine = _engine()
    _step(engine)
    before = {k: v.clone() for k, v in engine.model.state_dict().items()}
    moments = [{k: v.clone() for k, v in st.items()} for st in
               engine.optimizer.state_dict()["state"].values()]
    ckptr = AsyncCheckpointer()
    _save(ckptr.save, path, engine, 1)
    _step(engine, seed=1)
    ckptr.close()
    payload = torch.load(path, weights_only=True)
    assert _same_state(payload["model_dict"], before)
    assert not _same_state(payload["model_dict"], engine.model.state_dict())
    for got, want in zip(payload["optimizer"]["state"].values(), moments):
        assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.cuda
def test_snapshot_on_the_card_is_not_reached_by_the_next_step(tmp_path):
    """The same on the card, where the snapshot is an asynchronous copy
    on a side stream that the next step's kernels wait for."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.manual_seed(0)
    engine = Engine(build_model("FC_STGNN", "CMAPSS", "FD001"),
                    get_algorithm_spec("FC_STGNN"), TP, device="cuda")
    x = torch.from_numpy(x_rows(100, 0)).cuda()
    y = torch.rand(100, 1, device="cuda")
    engine.train_step(x, y)
    before = {k: v.cpu().clone() for k, v in engine.model.state_dict().items()}
    ckptr = AsyncCheckpointer()
    path = str(tmp_path / "checkpoint.pt")
    _save(ckptr.save, path, engine, 1)
    for _ in range(3):
        engine.train_step(x, y)
    ckptr.close()
    assert _same_state(torch.load(path, weights_only=True)["model_dict"],
                       before)


# ------------------------------------------------------------- resume


def test_checkpoint_resume(tmp_path):
    """Restore from a checkpoint and get the same predictions
    (tests/test_trainer_e2e.py:64-89)."""
    data = _bundle()
    engine = _engine()
    engine.run_epoch(data.train_x, data.train_y, 1, shuffle=True)
    before = engine.evaluate(data.test[0])
    path = str(tmp_path / "ckpt.pt")
    _save(save_checkpoint, path, engine, 1)
    fresh = _engine(seed=3)
    assert restore(path, fresh.model, fresh.optimizer) == 1
    np.testing.assert_array_equal(fresh.evaluate(data.test[0]), before)


def test_trainer_resume(tmp_path):
    """Interrupt after epoch 2, resume, and finish the remaining epochs
    (tests/test_trainer_e2e.py:92-111)."""
    common = dict(method="FC_STGNN", dataset="CMAPSS", dataset_id="FD001",
                  data=_bundle(), save_dir=str(tmp_path), num_runs=1,
                  train_params=dict(TP), device="cpu", checkpoint_every=1)
    Trainer(**common).train()
    common["train_params"]["num_epochs"] = 4
    results = Trainer(**common, resume=True).train()
    assert all(np.isfinite(v) for v in results[0][None])
    run_dir = tmp_path / "exp" / "run" / "FC_STGNN_run_0"
    log = (run_dir / "logs_run_0.log").read_text()
    assert "Resumed from epoch 2" in log and "[Epoch : 3/4]" in log
    assert torch.load(run_dir / "checkpoint.pt",
                      weights_only=True)["epoch"] == 4


def test_resume_at_the_last_epoch_evaluates_once(tmp_path):
    """A checkpoint at or past the last epoch: nothing is trained, its
    weights are evaluated once for the run's artifacts (JAX's
    trainer.py:462-468)."""
    common = dict(method="FC_STGNN", dataset="CMAPSS", dataset_id="FD001",
                  data=_bundle(), save_dir=str(tmp_path), num_runs=1,
                  train_params=dict(TP), device="cpu")
    Trainer(**common).train()
    run_dir = tmp_path / "exp" / "run" / "FC_STGNN_run_0"
    saved = torch.load(run_dir / "checkpoint.pt", weights_only=True)
    (run_dir / "results.csv").unlink()
    results = Trainer(**common, resume=True).train()
    log = (run_dir / "logs_run_0.log").read_text()
    assert log.count("[Epoch :") == 2 and "Resumed from epoch 2" in log
    assert (run_dir / "results.csv").exists()
    assert all(np.isfinite(v) for v in results[0][None])
    after = torch.load(run_dir / "checkpoint.pt", weights_only=True)
    assert _same_state(after["model_dict"], saved["model_dict"])


def _train_and_resume(tmp_path, method, dataset, dataset_id, data, tp):
    """The straight run of tp's epochs and the run interrupted after all
    but the last, saved every epoch and resumed by a new Trainer: their
    final checkpoints."""
    def run(name, epochs, **kw):
        Trainer(method, dataset, dataset_id, data,
                save_dir=str(tmp_path / name), num_runs=1,
                train_params={**tp, "num_epochs": epochs}, device="cpu",
                **kw).train()
        return torch.load(tmp_path / name / "exp" / "run" /
                          f"{method}_run_0" / "checkpoint.pt",
                          weights_only=True)
    straight = run("straight", tp["num_epochs"], checkpoint_every=1)
    run("cut", tp["num_epochs"] - 1, checkpoint_every=1)
    return straight, run("cut", tp["num_epochs"], resume=True)


@pytest.mark.parametrize("method", ["FC_STGNN", "LOGO_bearing"])
def test_resumed_run_equals_the_straight_run_with_dropout_on(tmp_path,
                                                             method):
    """Dropout on at the bank's rates (FC_STGNN's PE dropout 0.1,
    LOGO_bearing's 0.2): the run interrupted before its last epoch and
    resumed from its checkpoint ends bit for bit where the straight run
    does, weights, BatchNorm statistics, Adam, and LOGO_bearing's
    MultiStepLR (3 steps an epoch at batch 4: the resumed epoch crosses
    milestone 10 from step 8)."""
    if method == "FC_STGNN":
        cell, data = ("CMAPSS", "FD001"), _bundle(n_train=24)
        tp = {**TP, "batch_size": 8, "num_epochs": 3}
    else:
        cell = ("PHM2012", "Condition_1")
        data = _bundle(n_train=12, n_test=4, method=method)
        tp = {**bank.train_params(*cell, method), "batch_size": 4,
              "num_epochs": 4}
    drops = [m.p for m in build_model(method, *cell).modules()
             if isinstance(m, torch.nn.Dropout)]
    assert max(drops) > 0
    straight, resumed = _train_and_resume(tmp_path, method, *cell, data, tp)
    assert _same_state(straight["model_dict"], resumed["model_dict"])
    for a, b in zip(straight["optimizer"]["state"].values(),
                    resumed["optimizer"]["state"].values()):
        assert all(torch.equal(a[k], b[k]) for k in a)
    assert straight["scheduler"] == resumed["scheduler"]
    if method == "LOGO_bearing":
        assert resumed["scheduler"]["last_epoch"] == 12
        assert resumed["optimizer"]["param_groups"][0]["lr"] == \
            tp["learning_rate"] * 0.5 ** 2


def test_resumed_checkpoint_reads_into_jax(tmp_path):
    """The resumed run's checkpoint.pt through the JAX package's
    import_torch_checkpoint serves as the port's serving model does."""
    data = _bundle(n_train=24)
    _, resumed = _train_and_resume(tmp_path, "FC_STGNN", "CMAPSS", "FD001",
                                   data, {**TP, "batch_size": 8,
                                          "num_epochs": 2})
    path = tmp_path / "cut" / "exp" / "run" / "FC_STGNN_run_0" / \
        "checkpoint.pt"
    variables = import_torch_checkpoint(str(path), "FC_STGNN")
    model = jalgorithms.get_algorithm_spec("FC_STGNN").model_cls(
        **jax_hparams.model_hparams("CMAPSS", "FD001", "FC_STGNN"))
    x = data.test[0]
    want = np.asarray(model.apply(variables, jnp.asarray(x),
                                  train=False)).reshape(-1)
    got = serving_model("FC_STGNN", "CMAPSS", "FD001", resumed["model_dict"],
                        device="cpu")(x)
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-4)


def test_cli_checkpoints_every_epoch_and_resumes(tmp_path, monkeypatch):
    """--checkpoint_every 1 and then --resume through cli.main; at bf16 the
    checkpoint records its precision."""
    root = str(tmp_path)
    data_root = _write_fd001(root)
    orig = bank.train_params
    monkeypatch.setattr(bank, "train_params", lambda *a: {
        **orig(*a), "batch_size": 16})
    args = ["--GNN_method", "FC_STGNN", "--dataset", "CMAPSS",
            "--dataset_id", "FD001", "--data_path", data_root, "--save_dir",
            os.path.join(root, "logs"), "--device", "cpu", "--num_runs", "1",
            "--precision", "bf16"]
    cli.main(args + ["--epochs", "1", "--checkpoint_every", "1"])
    cli.main(args + ["--epochs", "2", "--resume"])
    run_dir = os.path.join(root, "logs", "GNN_RUL", "run_1",
                           "FC_STGNN_run_0")
    with open(os.path.join(run_dir, "logs_run_0.log")) as f:
        log = f.read()
    assert "Resumed from epoch 1" in log and "[Epoch : 2/2]" in log
    payload = torch.load(os.path.join(run_dir, "checkpoint.pt"),
                         weights_only=True)
    assert payload["epoch"] == 2 and payload["precision"] == "bf16"
    with pytest.raises(ValueError, match="checkpoint_every"):
        cli.main(args + ["--checkpoint_every", "-1"])
