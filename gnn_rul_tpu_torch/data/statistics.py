"""Processed-dataset shape/statistics inspector (counterpart of
``gnn_rul_tpu/data/statistics.py``, on the port's ``load_dataset``).

Equivalent of the reference's ad-hoc Data_Process/data_statistics_read.py:
prints sample/label shapes and label ranges for a processed directory.

    python -m gnn_rul_tpu_torch.data.statistics Processed_dataset/CMAPSS/FD001
"""

from __future__ import annotations

import sys

from .loader import load_dataset


def describe(data_path: str) -> None:
    bundle = load_dataset(data_path)
    print(f"dataset at {data_path}")
    print(f"  train_x: {bundle.train_x.shape} "
          f"[{bundle.train_x.min():.4f}, {bundle.train_x.max():.4f}]")
    print(f"  train_y: {bundle.train_y.shape} "
          f"[{bundle.train_y.min():.4f}, {bundle.train_y.max():.4f}]")
    if bundle.is_dict_test:
        for key, (tx, ty) in bundle.test.items():
            mr = (bundle.max_ruls[key]
                  if isinstance(bundle.max_ruls, dict) else bundle.max_ruls)
            print(f"  test[{key}]: x {tx.shape} y {ty.shape} max_rul {mr}")
    else:
        tx, ty = bundle.test
        print(f"  test_x: {tx.shape}  test_y: {ty.shape} "
              f"max_rul {bundle.max_ruls}")


if __name__ == "__main__":
    describe(sys.argv[1])
