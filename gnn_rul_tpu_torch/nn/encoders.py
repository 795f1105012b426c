"""1D-CNN feature encoders (counterpart of ``gnn_rul_tpu/nn/encoders.py``)."""

from __future__ import annotations

import torch
from torch import nn

from .basic import BatchNormNCL


class FeatureExtractor1DCNNRUL(nn.Module):
    """2-block 1D-CNN used by FC_STGNN.

    Reference Feature_extractor_1DCNN_RUL (models/FC_STGNN/Model_Base.py:12-41):
      conv_block1: Conv1d(in, hidden, k, pad k//2, no bias) -> BN -> ReLU
      conv_block2: Conv1d(hidden, out, k, pad 1, no bias)   -> BN -> ReLU

    Input (B, C_in, L) -> (B, out_dim, L'') with L' = L + 2*(k//2) - k + 1
    and L'' = L' + 2 - k + 1.
    """

    def __init__(self, num_hidden: int, out_dim: int, kernel_size: int = 8,
                 in_channels: int = 1):
        super().__init__()
        self.conv_block1 = nn.Sequential(
            nn.Conv1d(in_channels, num_hidden, kernel_size,
                      padding=kernel_size // 2, bias=False),
            BatchNormNCL(num_hidden), nn.ReLU())
        self.conv_block2 = nn.Sequential(
            nn.Conv1d(num_hidden, out_dim, kernel_size, padding=1, bias=False),
            BatchNormNCL(out_dim), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_block2(self.conv_block1(x))
