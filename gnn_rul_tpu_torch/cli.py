"""Command-line entry point (counterpart of ``gnn_rul_tpu/cli.py``).

The reference CLI's flags (main.py:8-39) and the JAX package's:

    python -m gnn_rul_tpu_torch.cli --GNN_method FC_STGNN --dataset CMAPSS \\
        --dataset_id FD001 --data_path Processed_dataset --num_runs 5

Trains on the card (``--device cuda``, the default; it raises where CUDA is
absent) or on the CPU (``--device cpu``); with ``--eval_torch_checkpoint
PT`` it evaluates the weights of a ``checkpoint.pt`` (the port's or the
reference's) on the test set instead of training; with ``--vectorized_runs``
it trains all ``--num_runs`` seeds at once (``train/vectorized.py``), each
run's artifacts as a sequential run writes them; ``--precision bf16``
trains in bfloat16 on fp32 state (``train/precision.py``);
``--checkpoint_every K`` writes each run's ``checkpoint.pt`` after every
K-th epoch, asynchronously, and ``--resume`` restarts each run from it;
``--profile DIR`` writes a ``torch.profiler`` trace of the second epoch
run; ``--mesh data=N,model=M`` trains across the N x M ranks of a
``torch.distributed`` job that the ``GNNRUL_*`` variables describe
(``parallel/multihost.py``; one process is a job of one): each batch's
rows split over the data ranks, the wide parameters (tensor parallelism)
and a hooked method's graph algebra over the model ranks (``parallel/``),
rank 0 alone writing artifacts. One line a rank, here two on the CPU::

    GNNRUL_COORDINATOR=localhost:29500 GNNRUL_NUM_PROCESSES=2 \\
    GNNRUL_PROCESS_ID=0 python -m gnn_rul_tpu_torch.cli --mesh data=2 \\
        --device cpu ...   # and GNNRUL_PROCESS_ID=1 the same

A job without ``--mesh`` splits the rows over every rank. The methods are
``models.MODELS``, all 21 of the reference: the twelve aero-engine methods
(FC_STGNN, LOGO, HAGCN, RGCNU, STAGNN, STFA, GRU_CM, STGNN, DVGTformer,
HierCorrPool, ASTGCNN, ST_Conv) and the nine bearing methods
(HierCorrPool_bearing, ST_GCN, SAGCN, AGCN_TF, STMSGCN, STNet, GAT_LSTM,
GDAGDL, LOGO_bearing); any other ``--GNN_method`` raises. The
processed datasets come from ``python -m gnn_rul_tpu_torch.data.preprocess``.
Flags that select
what is not ported yet raise ``NotImplementedError``; the port's order of
work is in ROADMAP.md.
"""

from __future__ import annotations

import argparse

from .data.loader import load_dataset, resolve_data_path
from .export import resolve_device
from .parallel.mesh import make_mesh
from .parallel.multihost import initialize_from_env
from .train.checkpoint import load_checkpoint
from .train.trainer import Trainer


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="GNN RUL benchmarking on PyTorch/CUDA")
    p.add_argument("--save_dir", default="experiments_logs")
    p.add_argument("--experiment_description", default="GNN_RUL")
    p.add_argument("--run_description", default="run_1")
    p.add_argument("--GNN_method", default="FC_STGNN")
    p.add_argument("--data_path", default="Processed_dataset")
    p.add_argument("--dataset", default="CMAPSS",
                   choices=["CMAPSS", "NCMAPSS", "PHM2012", "XJTU_SY"])
    p.add_argument("--dataset_id", default="FD001")
    p.add_argument("--bearing_id", default="Testing_bearing_1")
    p.add_argument("--num_runs", type=int, default=1)
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises where CUDA is absent) or cpu")
    p.add_argument("--checkpoint_every", type=int, default=0,
                   help="write checkpoint.pt after every K-th epoch, off the "
                        "training thread (0 = the final checkpoint only)")
    p.add_argument("--resume", action="store_true",
                   help="restart each run from its checkpoint.pt (weights, "
                        "BatchNorm statistics, Adam, scheduler, epoch)")
    p.add_argument("--precision", default="fp32", choices=["fp32", "bf16"],
                   help="bf16: the forward and backward in bfloat16 on fp32 "
                        "parameters, Adam and BatchNorm statistics")
    p.add_argument("--fused", default="auto", choices=["auto", "on", "off"],
                   help="the port always runs its kernels on the card; auto "
                        "and on are accepted, off is not ported")
    p.add_argument("--mesh", default=None, metavar="data=N,model=M",
                   help="train over a (data, model) mesh of the job's "
                        "ranks, e.g. 'data=2,model=2' (GNNRUL_COORDINATOR, "
                        "GNNRUL_NUM_PROCESSES and GNNRUL_PROCESS_ID a "
                        "rank; default: one process)")
    p.add_argument("--epochs", type=int, default=0,
                   help="override the hparam bank's num_epochs (0 = keep)")
    p.add_argument("--vectorized_runs", action="store_true",
                   help="train all --num_runs seeds at once, one vmapped "
                        "step for every seed (seed = run index, the "
                        "sequential runs' per-seed semantics, dropout masks "
                        "included; each run's artifacts as a sequential "
                        "run's)")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the second epoch "
                        "run into DIR (TensorBoard's profiler plugin, "
                        "chrome://tracing or Perfetto read it)")
    p.add_argument("--eval_torch_checkpoint", default=None, metavar="PT",
                   help="evaluate the weights of a checkpoint.pt (the "
                        "port's or the reference's) on the test set instead "
                        "of training")
    return p


def _refuse_unported(args: argparse.Namespace) -> None:
    if args.vectorized_runs and args.resume:
        raise ValueError("--vectorized_runs does not support --resume (the "
                         "runs advance in lockstep; resume a run on the "
                         "sequential path)")
    if args.checkpoint_every < 0:
        raise ValueError(f"--checkpoint_every must be >= 0, got "
                         f"{args.checkpoint_every}")
    if args.vectorized_runs and args.mesh is not None:
        raise ValueError("--vectorized_runs is a single-device capability "
                         "(it fills one chip with the seed axis); drop "
                         "--mesh or the flag")
    unported = {"--fused off": args.fused == "off"}
    for flag, asked in unported.items():
        if asked:
            raise NotImplementedError(
                f"{flag} is not ported yet; the port's order of work is in "
                "ROADMAP.md")


def parse_mesh_arg(spec: str, device: str = "cuda"):
    """``'data=N,model=M'`` (either part may be left out, as 1) -> the mesh
    of ``parallel/mesh.py::make_mesh`` over the job's ranks."""
    sizes = {"data": 1, "model": 1}
    for part in spec.split(","):
        k, _, v = part.partition("=")
        k = k.strip()
        if k not in sizes or not v.strip().isdigit() or int(v) < 1:
            raise ValueError(
                f"bad --mesh component {part!r} (want data=N,model=M)")
        sizes[k] = int(v)
    return make_mesh(n_data=sizes["data"], n_model=sizes["model"],
                     device=device)


def main(argv=None):
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    # Joins the job the GNNRUL_* variables describe, before the first
    # device query; a single process is untouched.
    distributed = initialize_from_env(args.device)
    resolve_device(args.device)  # before the data is read
    data = load_dataset(resolve_data_path(args.data_path, args.dataset,
                                          args.dataset_id, args.bearing_id))
    mesh = parse_mesh_arg(args.mesh, args.device) if args.mesh else None
    if distributed and mesh is None:
        mesh = make_mesh(device=args.device)  # the rows over every rank
    trainer = Trainer(
        method=args.GNN_method,
        dataset=args.dataset,
        dataset_id=args.dataset_id,
        data=data,
        save_dir=args.save_dir,
        experiment_description=args.experiment_description,
        run_description=args.run_description,
        num_runs=args.num_runs,
        num_epochs_override=args.epochs or None,
        device=args.device,
        vectorized_runs=args.vectorized_runs,
        precision=args.precision,
        resume=args.resume,
        checkpoint_every=args.checkpoint_every,
        mesh=mesh,
        profile_dir=args.profile,
    )
    if args.eval_torch_checkpoint:
        state_dict, _ = load_checkpoint(args.eval_torch_checkpoint)
        return trainer.evaluate_only(state_dict)
    return trainer.train()


if __name__ == "__main__":
    main()
