"""Graph-NN blocks shared across models (counterpart of
``gnn_rul_tpu/nn/gnn_blocks.py``; the ``spmm_fn`` hook of ``MPNNmk`` comes
with ``parallel/graph_partition.py``, ROADMAP.md)."""

from __future__ import annotations

import torch
from torch import nn

from ..ops.graphs import leaky_relu
from ..ops.message_passing import chebyshev_terms, khop_aggregate, spmm


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
    ``act(linear(D^-1/2 (A+I) D^-1/2 X))`` (reference models/STAGNN/Model.py:
    8-22; RGCNU's takes ``activation="none"`` and applies its ReLU after);
    the Linear is ``linear``. ``activation``: ``"leaky_relu"`` (slope 0.01),
    ``"relu"`` or ``"none"``."""

    def __init__(self, in_features: int, out_features: int,
                 activation: str = "leaky_relu"):
        super().__init__()
        if activation not in ("leaky_relu", "relu", "none"):
            raise ValueError(f"GCNLayer: activation must be 'leaky_relu', "
                             f"'relu' or 'none', got {activation!r}")
        self.activation = activation
        self.linear = nn.Linear(in_features, out_features)

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        n = adj.shape[-1]
        a = adj + torch.eye(n, dtype=adj.dtype, device=adj.device)
        d_inv_sqrt = a.sum(dim=-1) ** -0.5
        a_hat = a * d_inv_sqrt[..., :, None] * d_inv_sqrt[..., None, :]
        out = self.linear(spmm(a_hat, x))
        if self.activation == "leaky_relu":
            return leaky_relu(out)
        if self.activation == "relu":
            return torch.relu(out)
        return out


class ChebNet(nn.Module):
    """Chebyshev graph convolution ``sum_k T_k(A) X W_k`` (reference
    models/ASTGCNN/Model.py:198-230, models/STGNN/Model.py:29-61). The
    weights are ``filters (K, in, out)``, initialised by
    ``nn.init.xavier_uniform_`` on the 3-D tensor: fan_in = in*out and
    fan_out = K*out, as the JAX ``_xavier_uniform_3d`` draws them."""

    def __init__(self, in_channels: int, out_channels: int, K: int):
        super().__init__()
        self.K = K
        self.filters = nn.Parameter(torch.empty(K, in_channels, out_channels))
        nn.init.xavier_uniform_(self.filters)

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        terms = chebyshev_terms(adj, x, self.K)
        return sum(torch.matmul(t, self.filters[i])
                   for i, t in enumerate(terms))
