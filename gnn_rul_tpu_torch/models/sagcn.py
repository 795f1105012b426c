"""SAGCN: 40 handcrafted features a patch, a cosine graph over the patches,
a GCN, two projection layers and an attention over the nodes
(counterpart of ``gnn_rul_tpu/models/sagcn.py``).

Reference SAGCN_model (models/SAGCN/Model.py:99-162), under its keys. No
kernel of the port runs in this model; the spectral features' FFT is
``torch.fft.fft`` (cuFFT on the card).
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.gnn_blocks import GCNLayer
from ..ops.graphs import cosine_graph
from ..signal.features import sagcn_features

_FEATURES = 40  # sagcn_features a patch


class GraphProjectionLayer(nn.Module):
    """``relu(linear(project_matrices(x^T)^T))``
    (models/SAGCN/Model.py:99-112)."""

    def __init__(self, in_features: int, out_features: int, num_nodes: int):
        super().__init__()
        self.project_matrices = nn.Linear(num_nodes, num_nodes)
        self.linear = nn.Linear(in_features, out_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xw = self.project_matrices(x.transpose(-1, -2))
        return torch.relu(self.linear(xw.transpose(-1, -2)))


class SelfAttentionLayer(nn.Module):
    """``softmax(softmax_layer(tanh(tanh_layer(x^T))))^T``, a softmax over
    the nodes (models/SAGCN/Model.py:115-124)."""

    def __init__(self, num_nodes: int, attention_hidden_dim: int):
        super().__init__()
        self.tanh_layer = nn.Linear(num_nodes, attention_hidden_dim)
        self.softmax_layer = nn.Linear(attention_hidden_dim, num_nodes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        s = torch.tanh(self.tanh_layer(x.transpose(-1, -2)))
        return torch.softmax(self.softmax_layer(s), dim=-1).transpose(-1, -2)


class SAGCN(nn.Module):
    """Input ``(B, 1, num_patch * patch_size)`` -> ``(B, 1)``."""

    def __init__(self, num_patch: int, patch_size: int, gcn_hidden_dim: int,
                 attention_hidden_dim: int):
        super().__init__()
        self.num_patch, self.patch_size = num_patch, patch_size
        self.gcn1 = GCNLayer(_FEATURES, gcn_hidden_dim, activation="relu")
        self.proj1 = GraphProjectionLayer(gcn_hidden_dim, gcn_hidden_dim,
                                          num_patch)
        self.proj2 = GraphProjectionLayer(gcn_hidden_dim, gcn_hidden_dim,
                                          num_patch)
        self.attn = SelfAttentionLayer(num_patch, attention_hidden_dim)
        self.fc = nn.Linear(num_patch * gcn_hidden_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        feats = sagcn_features(
            x.reshape(b, self.num_patch, self.patch_size))  # (B, T, 40)
        h = self.gcn1(feats, cosine_graph(feats, eps=1e-12))
        h = self.proj2(self.proj1(h))
        h = h * self.attn(h)
        return self.fc(h.reshape(b, -1))
