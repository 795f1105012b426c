"""GAT_LSTM: 11 handcrafted statistics a patch, a path graph over the
patches, 3 graph-attention layers and 2 LSTMs (counterpart of
``gnn_rul_tpu/models/gat_lstm.py``).

Reference GAT_LSTM_model (models/GAT_LSTM/Model.py:112-165), under its
keys (``gat_layers.{i}``, ``lstm_layers.{i}``, ``fc``): each of the
``num_patch`` patches of the signal becomes a node of 11 statistics
(``signal/features.py::gat_lstm_features``); the nodes are joined by the
tri-diagonal path graph (:func:`path_graph`, one ``(N, N)`` shared by
every window); the reference's GAT copy adds a leaky_relu on each layer's
output (:100). Where the attention's dropout is inactive (eval, or a
dropout of 0) each layer is one launch of the graph-attention kernel with
the shared graph (``ops/kernels/fused_gat.py``); the bank's dropout of 0.2
sends a training forward down the plain panel, as in the JAX package.
The LSTMs run over the patches (cuDNN's ``nn.LSTM`` on the card), and the
``fc`` over every patch's output.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..nn.attention import GraphAttentionLayer
from ..nn.recurrent import LSTMLayer
from ..signal.features import gat_lstm_features

FEATURES = 11  # gat_lstm_features' statistics a patch


def path_graph(n: int, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """I plus the super- and sub-diagonal, ``(n, n)``
    (models/GAT_LSTM/Model.py:145-149)."""
    adj = torch.eye(n, dtype=dtype)
    idx = torch.arange(n - 1)
    adj[idx, idx + 1] = 1.0
    adj[idx + 1, idx] = 1.0
    return adj


class GATLSTM(nn.Module):
    """Input ``(B, 1, num_patch * patch_size)`` -> ``(B, 1)``. Takes the
    hparam bank's keyword arguments; ``gat_fn`` replaces the attention
    panel (the node-sharded engine, ``parallel/graph_partition.py``)."""

    def __init__(self, num_patch: int, patch_size: int,
                 hidden_dim: Sequence[int], lstm_hidden_dim: Sequence[int],
                 dropout: float = 0.1, alpha: float = 0.1, gat_fn=None):
        super().__init__()
        self.num_patch, self.patch_size = num_patch, patch_size
        dims = [FEATURES, *hidden_dim]
        self.gat_layers = nn.ModuleList(
            GraphAttentionLayer(i, o, dropout, negative_slope=alpha,
                                final_leaky_relu=True, gat_fn=gat_fn)
            for i, o in zip(dims, dims[1:]))
        lstm_dims = [dims[-1], *lstm_hidden_dim]
        self.lstm_layers = nn.ModuleList(
            LSTMLayer(i, o) for i, o in zip(lstm_dims, lstm_dims[1:]))
        self.fc = nn.Linear(num_patch * lstm_dims[-1], 1)
        self.register_buffer("adj", path_graph(num_patch), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        flat = x.reshape(b * self.num_patch, self.patch_size)
        h = gat_lstm_features(flat).reshape(b, self.num_patch, FEATURES)
        for gat in self.gat_layers:
            h = gat(h, self.adj)
        for lstm in self.lstm_layers:
            h, _ = lstm(h)
        return self.fc(h.reshape(b, -1))
