"""Graph-NN blocks shared across models (counterpart of
``gnn_rul_tpu/nn/gnn_blocks.py``; only what LOGO and STAGNN need so far)."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.graphs import leaky_relu
from ..ops.message_passing import khop_aggregate, spmm


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


class GCNLayer(nn.Module):
    """Symmetric-normalized GCN with self-loops,
    ``leaky_relu(linear(D^-1/2 (A+I) D^-1/2 X))`` (reference
    models/STAGNN/Model.py:8-22); the Linear is ``linear``. The JAX layer's
    ReLU variant (RGCNU) is not ported yet."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.linear = nn.Linear(in_features, out_features)

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        n = adj.shape[-1]
        a = adj + torch.eye(n, dtype=adj.dtype, device=adj.device)
        d_inv_sqrt = a.sum(dim=-1) ** -0.5
        a_hat = a * d_inv_sqrt[..., :, None] * d_inv_sqrt[..., None, :]
        return leaky_relu(self.linear(spmm(a_hat, x)))
