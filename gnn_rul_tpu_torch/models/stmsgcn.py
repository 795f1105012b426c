"""STMSGCN: spectral-energy-difference features, a chain of GCNs each on
the graph ``h h^T`` of its input, and a GRU over the patches (counterpart
of ``gnn_rul_tpu/models/stmsgcn.py``).

Reference STMSGCN_model (models/STMSGCN/Model.py:63-112), under its keys:
each patch's SED features are its nodes' scalar values; every GCN's
output is kept, and all scales side by side go through a GRU per node
over the patches (``gru_layer.gru``, cuDNN's on the card); the mean over
the nodes; a Linear head. The adjacency is not normalised before the
GCN's own ``D^-1/2 (A + I) D^-1/2``, as in the reference. No kernel of the
port runs in this model.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..nn.gnn_blocks import GCNLayer
from ..nn.recurrent import GRULayer
from ..ops.edge_count import record_edges
from ..signal.features import sed_features


class STMSGCN(nn.Module):
    """Input ``(B, 1, num_patch * patch_size)`` -> ``(B, 1)``."""

    def __init__(self, num_patch: int, patch_size: int, interval: int,
                 band_width: int, gcn_dims: Sequence[int],
                 gru_hidden_dim: int):
        super().__init__()
        self.num_patch, self.patch_size = num_patch, patch_size
        self.interval, self.band_width = interval, band_width
        dims = [1, *gcn_dims]
        self.gcn_layers = nn.ModuleList(GCNLayer(i, o)
                                        for i, o in zip(dims, dims[1:]))
        self.gru_layer = nn.ModuleDict(
            {"gru": GRULayer(sum(dims), gru_hidden_dim)})
        self.fc = nn.Linear(num_patch * gru_hidden_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t = x.shape[0], self.num_patch
        flat = x.reshape(b * t, self.patch_size)
        h = sed_features(flat, self.interval, self.band_width)[..., None]
        n = h.shape[1]
        outputs = [h]
        for gcn in self.gcn_layers:
            record_edges(h.shape[:-1] + (h.shape[-2],))
            h = gcn(h, torch.matmul(h, h.transpose(-1, -2)))
            outputs.append(h)
        cat = torch.cat(outputs, dim=-1).reshape(b, t, n, -1)
        cat = cat.transpose(1, 2).reshape(b * n, t, -1)
        out, _ = self.gru_layer["gru"](cat)
        out = out.reshape(b, n, t, -1).mean(dim=1)
        return self.fc(out.reshape(b, -1))
