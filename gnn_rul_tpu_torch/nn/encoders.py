"""1D-CNN feature encoders (counterpart of ``gnn_rul_tpu/nn/encoders.py``)."""

from __future__ import annotations

import torch
from torch import nn

from .basic import BatchNormNCL, Dropout


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


class FeatureExtractor1DCNN(nn.Module):
    """3-block 1D-CNN with max pooling used by HierCorrPool.

    Reference Feature_extractor_1DCNN (models/HierCorrPool/Model_Base.py:
    30-64), under its keys ``conv_block{1,2,3}.{0,1}``:
      conv_block1: Conv1d(in, hid, k, stride, pad k//2, no bias) -> BN
                   -> ReLU -> MaxPool1d(2, 2, pad 1) -> Dropout
      conv_block2: Conv1d(hid, hid*2, 8, pad 4, no bias) -> BN -> ReLU
                   -> MaxPool1d(2, 2, pad 1)
      conv_block3: Conv1d(hid*2, hid*4, 8, pad 4, no bias) -> BN -> ReLU
                   -> MaxPool1d(2, 2, pad 1)

    The output always has ``num_hidden * 4`` channels: the reference
    constructor's ``output_dimension`` is ignored, and not taken here.
    Input (B, C_in, L) -> (B, 4 * num_hidden, :func:`out_length` (L)).
    """

    def __init__(self, in_channels: int, num_hidden: int,
                 kernel_size: int = 8, stride: int = 1,
                 dropout: float = 0.35):
        super().__init__()
        self.kernel_size, self.stride = kernel_size, stride

        def block(c_in, c_out, k, stride, *tail):
            return nn.Sequential(
                nn.Conv1d(c_in, c_out, k, stride=stride, padding=k // 2,
                          bias=False),
                BatchNormNCL(c_out), nn.ReLU(),
                nn.MaxPool1d(2, 2, padding=1), *tail)

        self.conv_block1 = block(in_channels, num_hidden, kernel_size, stride,
                                 Dropout(dropout))
        self.conv_block2 = block(num_hidden, num_hidden * 2, 8, 1)
        self.conv_block3 = block(num_hidden * 2, num_hidden * 4, 8, 1)

    def out_length(self, length: int) -> int:
        """The output's length for an input of ``length`` steps."""
        for k, stride in ((self.kernel_size, self.stride), (8, 1), (8, 1)):
            length = (length + 2 * (k // 2) - k) // stride + 1  # the conv
            length = length // 2 + 1                           # the pool
        return length

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.conv_block3(self.conv_block2(self.conv_block1(x)))
