"""ASTGCNN: a TCN, a tanh gate, the gaussian graph and a ChebNet
(counterpart of ``gnn_rul_tpu/models/astgcnn.py``).

Reference ASTGCNN_model (models/ASTGCNN/Model.py:233-254): a TCN over the
sensors as channels -> the gate ``tanh(Linear(x) + b) * tcn_out`` -> ``A =
exp(-cdist(Px, Px))`` -> ChebNet -> the mean over the nodes -> Linear.
Submodule names are the original torch reference's
(``gnn_rul_tpu/compat/torch_import.py::_map_astgcnn``). No kernel of the
port runs in this model.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.gnn_blocks import ChebNet
from ..nn.tcn import TemporalConvNet
from ..ops.graphs import gaussian_graph


class GatingMechanism(nn.Module):
    """``tanh(theta(x) + bias)`` (models/ASTGCNN/Model.py:169-181): the
    Linear has its own bias and the module an extra one, initialised to
    zero."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.theta = nn.Linear(in_features, out_features)
        self.bias = nn.Parameter(torch.zeros(out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.theta(x) + self.bias)


class DistanceModule(nn.Module):
    """The graph's projection, a Linear WITHOUT bias (models/ASTGCNN/
    Model.py:184-195), and the gaussian graph of its output."""

    def __init__(self, in_features: int, out_features: int):
        super().__init__()
        self.P = nn.Linear(in_features, out_features, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return gaussian_graph(self.P(x))


class ASTGCNN(nn.Module):
    """Input ``(B, N, L)`` -> ``(B, 1)``. Takes the hparam bank's keyword
    arguments (``configs.hparams.model_hparams(dataset, sub_id,
    "ASTGCNN")``)."""

    def __init__(self, num_nodes: int, time_length: int, encoder_out_dim: int,
                 output_dim: int, K: int):
        super().__init__()
        self.tcn = TemporalConvNet(num_nodes, num_nodes, 6)
        self.gate = GatingMechanism(time_length, encoder_out_dim)
        self.distance_module = DistanceModule(encoder_out_dim,
                                              encoder_out_dim)
        self.chebnet = ChebNet(encoder_out_dim, output_dim, K)
        self.fc = nn.Linear(output_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gated = self.gate(x) * self.tcn(x)
        cheb = self.chebnet(gated, self.distance_module(gated))
        return self.fc(cheb.mean(dim=1))
