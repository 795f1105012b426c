"""AGCN_TF: 40 handcrafted features a patch, learned spatial (40 x 40) and
temporal (T x T) adjacencies, two MPNN branches and self-attention
(counterpart of ``gnn_rul_tpu/models/agcn_tf.py``).

Reference AGCN_TF_model (models/AGCN_TF/Model.py:104-189), under its keys.
The attention is the reference's plain scaled dot product, written out.
No kernel of the port runs in this model (nor a Pallas kernel in JAX).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from ..nn.gnn_blocks import MPNNmk
from ..ops.edge_count import record_edges
from ..signal.features import sagcn_features

_FEATURES = 40  # sagcn_features a patch


class SelfAttention(nn.Module):
    """``softmax(q k^T / sqrt(d)) v`` (models/AGCN_TF/Model.py:104-122)."""

    def __init__(self, d_model: int):
        super().__init__()
        self.d_model = d_model
        self.W_q = nn.Linear(d_model, d_model)
        self.W_k = nn.Linear(d_model, d_model)
        self.W_v = nn.Linear(d_model, d_model)

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        q, k, v = self.W_q(h), self.W_k(h), self.W_v(h)
        scores = torch.matmul(q, k.transpose(-1, -2)) / math.sqrt(
            self.d_model)
        return torch.matmul(torch.softmax(scores, dim=-1), v)


class MultiHeadSelfAttention(nn.Module):
    """The heads' outputs side by side (the reference's ``heads``)."""

    def __init__(self, d_model: int, num_heads: int):
        super().__init__()
        self.heads = nn.ModuleList(SelfAttention(d_model)
                                   for _ in range(num_heads))

    def forward(self, h: torch.Tensor) -> torch.Tensor:
        return torch.cat([head(h) for head in self.heads], dim=-1)


class AGCNTF(nn.Module):
    """Input ``(B, 1, num_patch * patch_size)`` -> ``(B, 1)``."""

    def __init__(self, num_patch: int, patch_size: int, hidden_adj_dim: int,
                 hidden_gnn_dim: int, num_heads: int = 1):
        super().__init__()
        self.num_patch, self.patch_size = num_patch, patch_size
        self.attention_spa_adj = nn.Sequential(
            nn.Linear(num_patch, hidden_adj_dim), nn.Tanh(),
            nn.Linear(hidden_adj_dim, _FEATURES))
        self.attention_tem_adj = nn.Sequential(
            nn.Linear(_FEATURES, hidden_adj_dim), nn.Tanh(),
            nn.Linear(hidden_adj_dim, num_patch))
        self.spatial_gnn = MPNNmk(num_patch, hidden_gnn_dim, k=1)
        self.temporal_gnn = MPNNmk(_FEATURES, hidden_gnn_dim, k=1)
        self.self_attention = MultiHeadSelfAttention(hidden_gnn_dim,
                                                     num_heads)
        self.fc = nn.Linear(
            (_FEATURES + num_patch) * hidden_gnn_dim * num_heads, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        feats = sagcn_features(
            x.reshape(b, self.num_patch, self.patch_size))  # (B, T, 40)
        feats_t = feats.transpose(-1, -2)                   # (B, 40, T)
        record_edges(x.shape[:-2] + (_FEATURES, _FEATURES))
        record_edges(x.shape[:-2] + (self.num_patch, self.num_patch))
        h_s = self.spatial_gnn(feats_t, self.attention_spa_adj(feats_t))
        h_t = self.temporal_gnn(feats, self.attention_tem_adj(feats))
        h = self.self_attention(torch.cat([h_s, h_t], dim=1))
        return self.fc(h.reshape(b, -1))
