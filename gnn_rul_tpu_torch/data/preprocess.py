"""Offline preprocessing CLI (counterpart of
``gnn_rul_tpu/data/preprocess.py``: the same flags and defaults; every
reader is numpy, with no pandas).

    python -m gnn_rul_tpu_torch.data.preprocess --dataset CMAPSS \\
        --data_root Datasets --dataset_id FD001
    python -m gnn_rul_tpu_torch.data.preprocess --dataset PHM2012 \\
        --data_root Datasets --condition 1
    python -m gnn_rul_tpu_torch.data.preprocess --dataset XJTU_SY \\
        --data_root Datasets --condition 2
    python -m gnn_rul_tpu_torch.data.preprocess --dataset NCMAPSS --data_root Datasets

Mirrors the reference's Data_Process scripts (run-as-script contract).
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser(description="Offline dataset preprocessing")
    p.add_argument("--dataset", required=True,
                   choices=["CMAPSS", "NCMAPSS", "PHM2012", "XJTU_SY"])
    p.add_argument("--data_root", default="Datasets")
    p.add_argument("--dataset_id", default="FD001",
                   help="CMAPSS sub-dataset (FD001..FD004)")
    p.add_argument("--condition", type=int, default=1,
                   help="PHM2012 / XJTU_SY condition (1..3)")
    p.add_argument("--out_dir", default="Processed_dataset")
    p.add_argument("--max_rul", type=int, default=125)
    p.add_argument("--seq_len", type=int, default=50)
    p.add_argument("--subsampling", type=int, default=100,
                   help="N-CMAPSS row subsampling")
    p.add_argument("--downsampling", type=int, default=1,
                   help="XJTU-SY within-minute downsampling")
    p.add_argument("--seed", type=int, default=0,
                   help="seed for the offline train shuffles (the reference's "
                        "were unseeded)")
    args = p.parse_args(argv)

    if args.dataset == "CMAPSS":
        from .cmapss import preprocess_cmapss
        preprocess_cmapss(args.data_root, args.dataset_id, args.max_rul,
                          args.seq_len, args.out_dir)
    elif args.dataset == "NCMAPSS":
        from .ncmapss import preprocess_ncmapss
        preprocess_ncmapss(args.data_root, args.seq_len, 1, args.subsampling,
                           args.out_dir)
    elif args.dataset == "PHM2012":
        from .phm2012 import preprocess_phm2012
        preprocess_phm2012(args.data_root, args.condition, args.out_dir,
                           args.seed)
    elif args.dataset == "XJTU_SY":
        from .xjtu_sy import preprocess_xjtu_sy
        preprocess_xjtu_sy(args.data_root, args.condition, args.downsampling,
                           args.out_dir, args.seed)
    print(f"{args.dataset} preprocessing complete -> {args.out_dir}")


if __name__ == "__main__":
    main()
