"""STAGNN: thresholded-covariance graph + (GCN, GAT) x2 + (TCN, temporal
attention) x2 (counterpart of ``gnn_rul_tpu/models/stagnn.py``).

Reference STAGNN_model (models/STAGNN/Model.py:181-227). After the GCN/GAT
stack the node axis is the TCN's channel axis and the node-feature axis its
length axis, so the final flatten is ``output_dim * hidden_dim``. Submodule
names are the original torch reference's, so ``state_dict()`` carries its
keys (``gnn_rul_tpu/compat/torch_import.py::_map_stagnn`` reads them).

The GAT heads have attention dropout 0, so their attention always goes
through ``ops/kernels/fused_gat.py``, in serving and in training: 2 GAT
layers x ``num_heads`` launches per forward on the card.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.attention import GAT
from ..nn.gnn_blocks import GCNLayer
from ..nn.tcn import TemporalConvNet
from ..ops.graphs import covariance_threshold_graph


class MultiHeadTemporalEncoder(nn.Module):
    """Per head, ``softmax(sigmoid(Linear(x^T)))`` over L reweights x; the
    mean over heads (models/STAGNN/Model.py:161-177). The heads' Linears are
    ``linears.{i}``, the reference's keys."""

    def __init__(self, in_channels: int, num_heads: int):
        super().__init__()
        self.linears = nn.ModuleList(nn.Linear(in_channels, 1)
                                     for _ in range(num_heads))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (B, C, L)
        xt = x.transpose(-1, -2)  # (B, L, C)
        outs = []
        for linear in self.linears:
            w = torch.sigmoid(linear(xt))                      # (B, L, 1)
            w = torch.softmax(w.transpose(-1, -2), dim=-1)     # (B, 1, L)
            outs.append(w * x)
        return torch.stack(outs).mean(dim=0)


class STAGNN(nn.Module):
    """Input ``(B, num_nodes, time_length)`` -> ``(B, 1)``. Takes the hparam
    bank's keyword arguments (``configs.hparams.model_hparams(dataset,
    sub_id, "STAGNN")``)."""

    def __init__(self, num_nodes: int, time_length: int, hidden_dim: int,
                 output_dim: int, num_heads: int, threshold: float):
        super().__init__()
        self.threshold = threshold
        self.gcn1 = GCNLayer(time_length, hidden_dim)
        self.gat1 = GAT(hidden_dim, hidden_dim, num_heads)
        self.gcn2 = GCNLayer(hidden_dim, hidden_dim)
        self.gat2 = GAT(hidden_dim, hidden_dim, num_heads)
        self.tcn1 = TemporalConvNet(num_nodes, hidden_dim, 2)
        self.temporal_encoder1 = MultiHeadTemporalEncoder(hidden_dim,
                                                          num_heads)
        self.tcn2 = TemporalConvNet(hidden_dim, output_dim, 2)
        self.temporal_encoder2 = MultiHeadTemporalEncoder(output_dim,
                                                          num_heads)
        self.fc = nn.Linear(output_dim * hidden_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        adj = covariance_threshold_graph(x, self.threshold)
        h = self.gcn1(x, adj)
        h = self.gat1(h, adj)
        h = self.gcn2(h, adj)
        h = self.gat2(h, adj)
        h = self.temporal_encoder1(self.tcn1(h))
        h = self.temporal_encoder2(self.tcn2(h))
        return self.fc(h.reshape(x.shape[0], -1))
