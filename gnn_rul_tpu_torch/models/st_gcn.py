"""ST_GCN: 10 handcrafted statistics a patch, a Pearson graph over them and
a stack of MPNN + TCN blocks (counterpart of ``gnn_rul_tpu/models/
st_gcn.py``).

Reference ST_GCN_model (models/ST_GCN/Model.py:176-222): the 10 feature
types are the graph's nodes, each with the ``num_patch`` values of its
statistic as features; ``num_layers`` (2) residual blocks of (1-hop MPNN
over the nodes -> causal TCN -> dropout), under the reference's keys
``sg_tcn.layers.{i}.0`` (the MPNN) and ``.1`` (the TCN); a max over the
10 nodes; a 2-layer MLP. No kernel of the port runs in this model.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.basic import Dropout
from ..nn.gnn_blocks import MPNNmk
from ..nn.tcn import TemporalConvNet
from ..ops.graphs import pearson_graph
from ..signal.features import st_gcn_features

_FEATURES = 10  # the statistics of st_gcn_features, the graph's nodes


class SGTCN(nn.Module):
    """The residual (MPNN -> TCN -> dropout) stack
    (models/ST_GCN/Model.py:176-195)."""

    def __init__(self, num_patch: int, num_layers: int, dropout: float):
        super().__init__()
        self.layers = nn.ModuleList(
            nn.ModuleList([MPNNmk(num_patch, num_patch, k=1),
                           TemporalConvNet(_FEATURES, _FEATURES, 2),
                           Dropout(dropout)])
            for _ in range(num_layers))

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        out = x
        for mpnn, tcn, drop in self.layers:
            out = drop(tcn(mpnn(out, adj))) + out
        return out


class STGCN(nn.Module):
    """Input ``(B, 1, num_patch * patch_size)`` -> ``(B, 1)``."""

    def __init__(self, num_patch: int, patch_size: int, num_layers: int = 2,
                 dropout: float = 0.5):
        super().__init__()
        self.num_patch, self.patch_size = num_patch, patch_size
        self.sg_tcn = SGTCN(num_patch, num_layers, dropout)
        self.fc1 = nn.Linear(num_patch, num_patch)
        self.fc2 = nn.Linear(num_patch, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        flat = x.reshape(b * self.num_patch, self.patch_size)
        feats = st_gcn_features(flat).reshape(b, self.num_patch, -1)
        feats = feats.transpose(-1, -2)          # (B, 10, num_patch)
        out = self.sg_tcn(feats, pearson_graph(feats))
        out = torch.amax(out, dim=1)             # max over the 10 features
        return self.fc2(torch.relu(self.fc1(out)))
