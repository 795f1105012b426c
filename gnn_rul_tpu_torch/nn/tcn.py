"""Shared 2-block dilated temporal convolution network (counterpart of
``gnn_rul_tpu/nn/tcn.py``).

Reference ``TemporalConvNet`` (models/ASTGCNN/Model.py:72-146, duplicated in
ST_Conv/STAGNN/ST_GCN), in the reference's layout and under its keys:

  conv_block1: Conv1d(k, dilation 1, pad k-1, no bias) -> Chomp1d -> BN -> ReLU
               + residual (``downsample0``, a 1x1 Conv1d with bias, when
               C_in != channels)                                  -> ReLU
  conv_block2: the same at dilation 2, pad 2(k-1), identity residual -> ReLU

The convolution pads both sides and the chomp drops the right side, so the
pair is causal and keeps the length; the JAX ``CausalConv1d`` pads the left
side only, the same function. The reference's weight-normed ``net0``/``net1``
submodules are built but never called in its forward, and are not
reproduced (as in the JAX package). A reference ``checkpoint.pt`` may carry
their keys; ``train.checkpoint.load_model_dict`` (under
``export.serving_model`` and the trainer) drops every key under ``<tcn>.net0.``
and ``<tcn>.net1.`` of each ``TemporalConvNet`` in the model before its
strict load, so such a checkpoint loads while any other unexpected key
still fails.
"""

from __future__ import annotations

from typing import List

import torch
from torch import nn

from .basic import BatchNormNCL


class Chomp1d(nn.Module):
    """Drops the last ``chomp`` steps of ``(B, C, L)``."""

    def __init__(self, chomp: int):
        super().__init__()
        self.chomp = chomp

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x[..., :x.shape[-1] - self.chomp].contiguous()


def causal_conv1d(in_channels: int, out_channels: int, kernel_size: int,
                  dilation: int = 1) -> List[nn.Module]:
    """The causal convolution without bias (counterpart of the JAX
    ``CausalConv1d``) as the reference's two modules: ``Conv1d`` padded by
    ``(k-1)*dilation`` on both sides, then the chomp of the right side."""
    pad = (kernel_size - 1) * dilation
    return [nn.Conv1d(in_channels, out_channels, kernel_size, padding=pad,
                      dilation=dilation, bias=False),
            Chomp1d(pad)]


class TemporalConvNet(nn.Module):
    """Input ``(B, C_in, L)`` -> ``(B, channels, L)``."""

    def __init__(self, in_channels: int, channels: int, kernel_size: int):
        super().__init__()
        self.conv_block1 = nn.Sequential(
            *causal_conv1d(in_channels, channels, kernel_size, 1),
            BatchNormNCL(channels), nn.ReLU())
        self.conv_block2 = nn.Sequential(
            *causal_conv1d(channels, channels, kernel_size, 2),
            BatchNormNCL(channels), nn.ReLU())
        self.downsample0 = (nn.Conv1d(in_channels, channels, 1)
                            if in_channels != channels else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        res = x if self.downsample0 is None else self.downsample0(x)
        out0 = torch.relu(self.conv_block1(x) + res)
        return torch.relu(self.conv_block2(out0) + out0)
