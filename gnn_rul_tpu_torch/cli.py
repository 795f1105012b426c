"""Command-line entry point (counterpart of ``gnn_rul_tpu/cli.py``).

The reference CLI's flags (main.py:8-39) and the JAX package's:

    python -m gnn_rul_tpu_torch.cli --GNN_method FC_STGNN --dataset CMAPSS \\
        --dataset_id FD001 --data_path Processed_dataset --num_runs 5

Trains on the card (``--device cuda``, the default; it raises where CUDA is
absent) or on the CPU (``--device cpu``); with ``--eval_torch_checkpoint
PT`` it evaluates the weights of a ``checkpoint.pt`` (the port's or the
reference's) on the test set instead of training. The ported methods are
the twelve aero-engine methods (``models.MODELS``): FC_STGNN, LOGO, HAGCN,
RGCNU, STAGNN, STFA, GRU_CM, STGNN, DVGTformer, HierCorrPool, ASTGCNN and
ST_Conv; any other ``--GNN_method`` raises. Flags that select
what is not ported yet raise ``NotImplementedError``; the port's order of
work is in ROADMAP.md.
"""

from __future__ import annotations

import argparse

from .data.loader import load_dataset, resolve_data_path
from .export import resolve_device
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
                   help="periodic checkpoints: not ported yet (0 = final "
                        "checkpoint only)")
    p.add_argument("--resume", action="store_true",
                   help="resume from a checkpoint: not ported yet")
    p.add_argument("--precision", default="fp32", choices=["fp32", "bf16"],
                   help="bf16 compute: not ported yet")
    p.add_argument("--fused", default="auto", choices=["auto", "on", "off"],
                   help="the port always runs its kernels on the card; auto "
                        "and on are accepted, off is not ported")
    p.add_argument("--mesh", default=None, metavar="data=N,model=M",
                   help="device mesh: not ported yet")
    p.add_argument("--epochs", type=int, default=0,
                   help="override the hparam bank's num_epochs (0 = keep)")
    p.add_argument("--vectorized_runs", action="store_true",
                   help="seed-parallel runs: not ported yet")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="profiler trace of an epoch: not ported yet")
    p.add_argument("--eval_torch_checkpoint", default=None, metavar="PT",
                   help="evaluate the weights of a checkpoint.pt (the "
                        "port's or the reference's) on the test set instead "
                        "of training")
    return p


def _refuse_unported(args: argparse.Namespace) -> None:
    unported = {
        "--mesh": args.mesh is not None,
        "--precision bf16": args.precision == "bf16",
        "--vectorized_runs": args.vectorized_runs,
        "--resume": args.resume,
        "--checkpoint_every": args.checkpoint_every > 0,
        "--profile": args.profile is not None,
        "--fused off": args.fused == "off",
    }
    for flag, asked in unported.items():
        if asked:
            raise NotImplementedError(
                f"{flag} is not ported yet; the port's order of work is in "
                "ROADMAP.md")


def main(argv=None):
    args = build_parser().parse_args(argv)
    _refuse_unported(args)
    resolve_device(args.device)  # before the data is read
    data = load_dataset(resolve_data_path(args.data_path, args.dataset,
                                          args.dataset_id, args.bearing_id))
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
    )
    if args.eval_torch_checkpoint:
        state_dict, _ = load_checkpoint(args.eval_torch_checkpoint)
        return trainer.evaluate_only(state_dict)
    return trainer.train()


if __name__ == "__main__":
    main()
