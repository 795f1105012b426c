"""GRU_CM: per-timestep full-graph edge-MLP message passing and a GRU
(counterpart of ``gnn_rul_tpu/models/gru_cm.py``).

Reference GRU_CM_model (models/GRU_CM/Model.py:43-82). Submodule names are
the original torch reference's, so ``state_dict()`` carries its keys
(``gnn_rul_tpu/compat/torch_import.py::_map_gru_cm`` reads them). No
kernel of the port runs in this model: the JAX package's edge-MLP kernel
was removed (``gnn_rul_tpu/models/gru_cm.py:23-29``).
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.basic import Dropout
from ..nn.recurrent import GRULayer
from ..ops.edge_count import record_edges


class GNNLayer(nn.Module):
    """Edge MLP over all N^2 pairs, a sum over the sources and a node MLP
    (models/GRU_CM/Model.py:6-40). The edge MLP is ``edge_mlp.0 =
    Linear(2f, out)`` on ``cat[x_i, x_j]``; it is applied as the two halves
    of its weight, ``x_i W1 + x_j W2``, broadcast into the ``(B, L, N, N,
    out)`` ReLU panel without the ``2f`` concatenation, as the JAX layer
    forms it."""

    def __init__(self, input_dim: int, output_dim: int):
        super().__init__()
        self.edge_mlp = nn.Sequential(nn.Linear(2 * input_dim, output_dim),
                                      nn.ReLU())
        self.node_mlp = nn.Sequential(
            nn.Linear(input_dim + output_dim, output_dim), nn.ReLU())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        f = x.shape[-1]
        edge = self.edge_mlp[0]
        p1 = torch.matmul(x, edge.weight[:, :f].t())    # (B, L, N, out)
        p2 = torch.matmul(x, edge.weight[:, f:].t())
        record_edges(x.shape[:-1] + (x.shape[-2],))
        panel = torch.relu(p1[..., :, None, :] + p2[..., None, :, :]
                           + edge.bias)                # (B, L, N, N, out)
        node = torch.cat([x, panel.sum(dim=3)], dim=-1)
        return self.node_mlp(node)


class GRUCM(nn.Module):
    """Input ``(B, N, L)`` -> ``(B, 1)``. Takes the hparam bank's keyword
    arguments (``configs.hparams.model_hparams(dataset, sub_id,
    "GRU_CM")``); the node width is ``num_nodes // 2``."""

    def __init__(self, num_nodes: int, time_length: int,
                 gru_hidden_dim: int = 128):
        super().__init__()
        hidden = int(num_nodes / 2)
        self.input_linear = nn.Linear(1, hidden)
        self.dropout1 = Dropout(0.2)
        self.gnn = GNNLayer(hidden, hidden)
        self.dropout2 = Dropout(0.2)
        self.gru = GRULayer(hidden, gru_hidden_dim)
        self.dropout3 = Dropout(0.2)
        self.output_linear = nn.Linear(time_length * gru_hidden_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.dropout1(self.input_linear(x.transpose(1, 2)[..., None]))
        h = self.dropout2(self.gnn(h))                  # (B, L, N, hidden)
        h, _ = self.gru(h.amax(dim=2))
        h = self.dropout3(h)
        return self.output_linear(h.reshape(x.shape[0], -1))
