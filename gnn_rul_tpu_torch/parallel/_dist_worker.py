"""One rank of a multi-process training job, and the launcher of such jobs
(counterpart of ``gnn_rul_tpu/parallel/_dist_worker.py``).

The worker joins the job that its ``GNNRUL_*`` variables describe
(``multihost.initialize_from_env``), forms the (data, model) mesh over
every rank, trains FC_STGNN for a few epochs through the ordinary
:class:`~..train.trainer.Trainer` on a synthetic C-MAPSS bundle (the same
on every rank) and writes its view of the results to
``<outdir>/result_p<rank>.json``; each rank's artifacts go under
``<outdir>/artifacts_p<rank>``, so a launcher can check that rank 0 alone
wrote any. One line a rank, on the CPU::

    GNNRUL_COORDINATOR=localhost:29500 GNNRUL_NUM_PROCESSES=2 \\
    GNNRUL_PROCESS_ID=0 python -m gnn_rul_tpu_torch.parallel._dist_worker \\
        --outdir out --device cpu

or :func:`launch` to start every rank of a job and wait for it.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

# The package's root, for the ranks' PYTHONPATH.
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def synthetic_cmapss(n: int, channels: int = 14, length: int = 50,
                     seed: int = 0):
    """Seeded ``(samples, labels)`` in the preprocessor's layout, the same
    on every rank and in the launcher."""
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n, channels, length)).astype(np.float32)
    y = rng.uniform(size=(n, 1)).astype(np.float32)
    return x, y


def make_bundle(n_train: int = 52, n_test: int = 12):
    from ..data.loader import DataBundle
    x, y = synthetic_cmapss(n_train, seed=0)
    tx, ty = synthetic_cmapss(n_test, seed=1)
    return DataBundle(x, y, (tx, ty), 125.0)


def run_training(outdir: str, epochs: int = 2, n_model: int = 1,
                 resume: bool = False, device: str = "cuda",
                 checkpoint_every: int = 1):
    """Trains FC_STGNN on the mesh of every rank (of this process alone
    outside a job) on ``device`` (``"cuda"``, or ``"cpu"`` where the
    caller asks); returns ``(results, rank)``."""
    import torch.distributed as dist
    from ..train.trainer import Trainer
    from .mesh import make_mesh
    mesh = make_mesh(n_model=n_model, device=device)
    trainer = Trainer(
        method="FC_STGNN", dataset="CMAPSS", dataset_id="FD001",
        data=make_bundle(), save_dir=outdir, experiment_description="dist",
        run_description="run", num_runs=1, mesh=mesh, device=device,
        checkpoint_every=checkpoint_every, resume=resume,
        train_params={"num_epochs": epochs, "batch_size": 16,
                      "learning_rate": 1e-3, "weight_decay": 1e-4})
    return trainer.train(), dist.get_rank()


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--outdir", required=True)
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--n_model", type=int, default=1)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises where CUDA is absent) or cpu")
    ap.add_argument("--resume", action="store_true",
                    help="resume from rank 0's periodic checkpoint: rank 0 "
                         "reads it and sends its state and epoch to every "
                         "rank")
    args = ap.parse_args(argv)
    import torch
    import torch.distributed as dist
    from .multihost import initialize_from_env
    torch.set_num_threads(1)
    if not initialize_from_env(args.device):
        raise RuntimeError("the GNNRUL_* variables describe no job")
    rank = dist.get_rank()
    # Each rank writes under its own directory, so that the launcher sees
    # which ranks wrote anything.
    save_dir = os.path.join(args.outdir, f"artifacts_p{rank}")
    results, rank = run_training(save_dir, epochs=args.epochs,
                                 n_model=args.n_model, resume=args.resume,
                                 device=args.device)
    payload = {"rank": rank, "world": dist.get_world_size(),
               "backend": dist.get_backend(),
               "best": {str(k): list(map(float, v))
                        for k, v in results[0].items()}}
    with open(os.path.join(args.outdir, f"result_p{rank}.json"), "w") as f:
        json.dump(payload, f)
    dist.destroy_process_group()


def free_port() -> int:
    """A TCP port free on localhost now."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def launch(argv: Sequence[str], nproc: int, timeout: float,
           env: Optional[Dict[str, str]] = None,
           log_dir: Optional[str] = None) -> List[str]:
    """Runs ``python <argv>`` as every rank of an ``nproc``-rank job on
    this host (``GNNRUL_*`` set for each, one thread each) and waits for
    all of them; returns each rank's output. Where a rank fails, or the job
    outlasts ``timeout`` seconds, every rank still running is killed and
    RuntimeError raised with the ranks' output. ``log_dir`` keeps each
    rank's output in ``rank<r>.log`` (default: a temporary file)."""
    import tempfile
    port = free_port()
    base = dict(os.environ, **(env or {}))
    base["PYTHONPATH"] = os.pathsep.join(
        p for p in (_ROOT, base.get("PYTHONPATH")) if p)
    base.update(GNNRUL_COORDINATOR=f"localhost:{port}",
                GNNRUL_NUM_PROCESSES=str(nproc), OMP_NUM_THREADS="1")
    log_dir = log_dir or tempfile.mkdtemp(prefix="gnnrul_job_")
    os.makedirs(log_dir, exist_ok=True)
    procs, logs = [], []
    for rank in range(nproc):
        logs.append(open(os.path.join(log_dir, f"rank{rank}.log"), "w+"))
        procs.append(subprocess.Popen(
            [sys.executable, *argv], env=dict(base,
                                              GNNRUL_PROCESS_ID=str(rank)),
            stdout=logs[-1], stderr=subprocess.STDOUT))
    deadline = time.monotonic() + timeout
    failed = None
    while any(p.poll() is None for p in procs):
        if any(p.poll() not in (None, 0) for p in procs):
            failed = "a rank failed"
            break
        if time.monotonic() > deadline:
            failed = f"the job outlasted {timeout} s"
            break
        time.sleep(0.05)
    for p in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
    outs = []
    for log in logs:
        log.seek(0)
        outs.append(log.read())
        log.close()
    if failed is None and any(p.returncode for p in procs):
        failed = "a rank failed"
    if failed:
        tails = "\n".join(f"--- rank {r} (exit {p.returncode}):\n{o[-4000:]}"
                          for r, (p, o) in enumerate(zip(procs, outs)))
        raise RuntimeError(f"{' '.join(argv)} x {nproc}: {failed}\n{tails}")
    return outs


if __name__ == "__main__":
    main()
