"""Jobs of two processes on the CPU (gloo), mirroring
tests/test_multihost.py: ``python -m gnn_rul_tpu_torch.parallel.
_dist_worker`` as both ranks (FC_STGNN through the Trainer on
``data=2``, and on ``data=1, model=2`` through the node-sharded hook), the
first job resumed by a new one from rank 0's checkpoint, and ``python -m
gnn_rul_tpu_torch.cli --mesh data=2`` training LOGO. Every
rank reports the same results, rank 1 writes nothing, and the results
equal one process's run of the same job."""

import json
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from gnn_rul_tpu_torch import cli
from gnn_rul_tpu_torch.parallel._dist_worker import launch, run_training
from test_torch_cli import _write_fd001

JOB_TIMEOUT = 240
RUN = os.path.join("dist", "run", "FC_STGNN_run_0")
PARAM_MAX_DIFF = 5e-4


def _worker(outdir, *args):
    return ["-m", "gnn_rul_tpu_torch.parallel._dist_worker", "--outdir",
            outdir, "--device", "cpu", *args]


def _results(outdir):
    return [json.load(open(os.path.join(outdir, f"result_p{r}.json")))
            for r in (0, 1)]


def _params(path):
    return torch.load(path, map_location="cpu",
                      weights_only=True)["model_dict"]


def _max_diff(a, b):
    return max((a[k].double() - b[k].double()).abs().max().item()
               for k in a if a[k].is_floating_point())


def _cli_args(data_root, save_dir):
    return ["--GNN_method", "LOGO", "--data_path", data_root, "--save_dir",
            save_dir, "--device", "cpu", "--epochs", "2"]


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """The worker's job (2 epochs, a checkpoint each), the same on
    ``data=1, model=2`` and the CLI's, at once; then a job resuming the
    first to 3 epochs."""
    root = tmp_path_factory.mktemp("multihost")
    trained, hooked = str(root / "trained"), str(root / "model_axis")
    data_root = _write_fd001(str(root), n_train=20, n_test=6)
    cli_dir = str(root / "cli")
    with ThreadPoolExecutor(3) as pool:
        done = [pool.submit(launch, _worker(trained, "--epochs", "2"), 2,
                            JOB_TIMEOUT),
                pool.submit(launch, _worker(hooked, "--epochs", "2",
                                            "--n_model", "2"), 2,
                            JOB_TIMEOUT),
                pool.submit(launch, ["-m", "gnn_rul_tpu_torch.cli",
                                     *_cli_args(data_root, cli_dir),
                                     "--mesh", "data=2"], 2, JOB_TIMEOUT)]
        for f in done:
            f.result()
    first = _results(trained)
    launch(_worker(trained, "--epochs", "3", "--resume"), 2, JOB_TIMEOUT)
    return {"root": root, "data_root": data_root, "trained": first,
            "resumed": _results(trained), "dir": trained, "cli": cli_dir,
            "model_axis": _results(hooked)}


def test_two_process_training(jobs):
    r0, r1 = jobs["trained"]
    assert (r0["rank"], r1["rank"]) == (0, 1)
    assert r0["world"] == r1["world"] == 2
    assert r0["backend"] == r1["backend"] == "gloo"
    np.testing.assert_allclose(r0["best"]["None"], r1["best"]["None"],
                               rtol=1e-6)


def test_rank_one_writes_nothing(jobs):
    run_dir = os.path.join(jobs["dir"], "artifacts_p0", RUN)
    for name in ("results.csv", "results.npz", "checkpoint.pt",
                 "logs_run_0.log"):
        assert os.path.exists(os.path.join(run_dir, name)), name
    assert not os.path.exists(os.path.join(jobs["dir"], "artifacts_p1"))


def test_two_process_results_equal_one_process(jobs):
    """The job against one process's run of it (a world of one)."""
    single = str(jobs["root"] / "single")
    results, rank = run_training(single, epochs=2, device="cpu")
    assert rank == 0
    np.testing.assert_allclose(jobs["trained"][0]["best"]["None"],
                               results[0][None], rtol=1e-3, atol=1e-3)


def test_model_axis_job_equals_one_process(jobs):
    """``data=1, model=2``: the trainer gives FC_STGNN the node-sharded
    engine's hook (tests/test_multihost.py's model-axis job); both ranks
    report one process's results."""
    r0, r1 = jobs["model_axis"]
    np.testing.assert_allclose(r0["best"]["None"], r1["best"]["None"],
                               rtol=1e-6)
    results, _ = run_training(str(jobs["root"] / "single_hooked"), epochs=2,
                              device="cpu")
    np.testing.assert_allclose(r0["best"]["None"], results[0][None],
                               rtol=1e-3, atol=1e-3)


def test_resume_broadcasts_from_rank_zero(jobs):
    """Rank 1 holds no checkpoint: rank 0 reads its own and sends the
    state and the epoch; the resumed job lands on one process's straight
    run of 3 epochs."""
    r0, r1 = jobs["resumed"]
    np.testing.assert_allclose(r0["best"]["None"], r1["best"]["None"],
                               rtol=1e-6)
    run_dir = os.path.join(jobs["dir"], "artifacts_p0", RUN)
    assert "Resumed from epoch 2" in open(
        os.path.join(run_dir, "logs_run_0.log")).read()
    assert not os.path.exists(os.path.join(jobs["dir"], "artifacts_p1"))
    straight = str(jobs["root"] / "straight")
    results, _ = run_training(straight, epochs=3, device="cpu")
    np.testing.assert_allclose(r0["best"]["None"], results[0][None],
                               rtol=1e-3, atol=1e-3)
    assert _max_diff(_params(os.path.join(run_dir, "checkpoint.pt")),
                     _params(os.path.join(straight, RUN, "checkpoint.pt"))) \
        < PARAM_MAX_DIFF


def test_cli_mesh_job_equals_one_process(jobs):
    """``cli --mesh data=2`` as two ranks: rank 0's LOGO checkpoint and
    results against the CLI in this process (LOGO's Bi-LSTM runs along the
    rows, so the data axis gathers them)."""
    single = str(jobs["root"] / "cli_single")
    results = cli.main(_cli_args(jobs["data_root"], single))
    run = os.path.join("GNN_RUL", "run_1", "LOGO_run_0")
    got = np.loadtxt(os.path.join(jobs["cli"], run, "results.csv"),
                     delimiter=",", skiprows=1, ndmin=2)[-1]
    np.testing.assert_allclose(got, results[0][None], rtol=1e-3, atol=1e-3)
    assert _max_diff(_params(os.path.join(jobs["cli"], run, "checkpoint.pt")),
                     _params(os.path.join(single, run, "checkpoint.pt"))) \
        < PARAM_MAX_DIFF
