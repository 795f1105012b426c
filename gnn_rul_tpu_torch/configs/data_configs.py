"""Copy of ``gnn_rul_tpu/configs/data_configs.py``: the port keeps its own.

Per-dataset shape/loader configs.

Values identical to reference configs/data_model_configs.py:7-48.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    name: str
    sequence_len: int
    input_channels: int
    shuffle: bool
    drop_last: bool = False
    normalize: bool = False


DATASETS = {
    "CMAPSS": DatasetConfig("CMAPSS", 50, 14, shuffle=True),
    "NCMAPSS": DatasetConfig("NCMAPSS", 50, 20, shuffle=True),
    "PHM2012": DatasetConfig("PHM2012", 2560, 1, shuffle=False),
    "XJTU_SY": DatasetConfig("XJTU_SY", 30768, 1, shuffle=False),
}


def get_dataset_config(name: str) -> DatasetConfig:
    if name not in DATASETS:
        raise NotImplementedError(f"Dataset not found: {name}")
    return DATASETS[name]
