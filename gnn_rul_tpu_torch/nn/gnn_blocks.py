"""Graph-NN blocks shared across models (counterpart of
``gnn_rul_tpu/nn/gnn_blocks.py``; only what LOGO needs so far)."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.graphs import leaky_relu
from ..ops.message_passing import khop_aggregate


class MPNNmk(nn.Module):
    """k-hop MPNN: ``leaky_relu(sum_k theta[k](A^k X))`` (reference MPNN_mk,
    models/LOGO/Model.py:130-160). The k Linears are ``theta.{k}``, the
    reference's keys."""

    def __init__(self, input_dim: int, output_dim: int, k: int = 1):
        super().__init__()
        self.k = k
        self.theta = nn.ModuleList(nn.Linear(input_dim, output_dim)
                                   for _ in range(k))

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        hops = khop_aggregate(adj, x, self.k)
        out = sum(theta(h) for theta, h in zip(self.theta, hops))
        return leaky_relu(out)
