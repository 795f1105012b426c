"""The layers torch.nn lacks (counterpart of ``gnn_rul_tpu/nn/basic.py``).

``nn.Linear``, ``nn.Conv1d`` and ``nn.BatchNorm1d`` (eps 1e-5, momentum 0.1)
already have the semantics the JAX package rebuilds; only the layouts differ.
"""

from __future__ import annotations

import torch
from torch import nn


class BatchNorm1d(nn.BatchNorm1d):
    """BatchNorm over the LAST axis: the leading axes are flattened into the
    batch, as the JAX ``BatchNorm1d`` reduces over every axis but the last."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return super().forward(x.reshape(-1, x.shape[-1])).reshape(x.shape)


class BatchNormNCL(nn.BatchNorm1d):
    """BatchNorm on ``(B, C, L)``, per channel over ``(B, L)``: torch's own
    layout, kept as a class so each JAX layer has a counterpart."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dim() != 3:
            raise ValueError(f"BatchNormNCL expects (B, C, L), got "
                             f"{tuple(x.shape)}")
        return super().forward(x)
