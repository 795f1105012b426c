"""The layers torch.nn lacks (counterpart of ``gnn_rul_tpu/nn/basic.py``).

``nn.Linear``, ``nn.Conv1d`` and ``nn.BatchNorm1d`` (eps 1e-5, momentum 0.1)
already have the semantics the JAX package rebuilds; only the layouts differ.
"""

from __future__ import annotations

import math

import torch
from torch import nn


class GELU(nn.Module):
    """The exact GELU, ``x * Phi(x)``, computed as ``0.5 * x * erfc(-x /
    sqrt(2))``, the form ``jax.nn.gelu(approximate=False)`` takes.
    ``torch.nn.GELU`` computes ``0.5 * x * (1 + erf(x / sqrt(2)))``, whose
    ``1 + erf`` cancels in fp32 below x = -3: 17% off at x = -5 and 0 from
    x = -5.5 (the true value -5.9e-9 at -6), gradient included (ROADMAP.md,
    Queue 3). No parameters, so the reference's keys are unchanged where
    it replaces ``nn.GELU``."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return 0.5 * x * torch.erfc(-x * (1.0 / math.sqrt(2.0)))


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


class MLP(nn.Sequential):
    """``Linear`` layers with a ReLU between them and none after the last
    (the JAX ``MLP``), as the reference's ``nn.Sequential``: its Linears
    are ``0``, ``2``, ``4`` ..."""

    def __init__(self, in_features: int, features):
        layers = []
        for i, out_features in enumerate(features):
            if i:
                layers.append(nn.ReLU())
            layers.append(nn.Linear(in_features, out_features))
            in_features = out_features
        super().__init__(*layers)
