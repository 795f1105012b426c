"""RGCNU: a learned directed graph, a per-timestep GCN, an LSTM and a CNN
fusion (counterpart of ``gnn_rul_tpu/models/rgcnu.py``).

Reference RGCNU_model (models/RGCNU/Model.py:93-119). Training returns
``(pred, std)``; the std head is unused by the reference's training loss
(algorithms.py:287-290, aux weight 0 here) but still produced. Submodule
names are the original torch reference's, so ``state_dict()`` carries its
keys (``gnn_rul_tpu/compat/torch_import.py::_map_rgcnu`` reads them).

Reference quirk kept: ``A.repeat(L, 1, 1)`` tiles the batch of adjacencies
L times (models/RGCNU/Model.py:108), while X is flattened b-major as
``(B*L)``, so sample b at timestep l is paired with ``A[(b*L + l) % B]``,
not with its own adjacency. No kernel of the port runs in this model.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.gnn_blocks import GCNLayer
from ..nn.recurrent import LSTMLayer


class AdjConstruction(nn.Module):
    """``relu(tanh(alpha * (A1 A2^T - A2 A1^T)))`` with ``A_i =
    tanh(alpha * trainable_theta_i(x))`` (models/RGCNU/Model.py:77-90)."""

    def __init__(self, num_nodes: int, time_length: int, alpha: float):
        super().__init__()
        self.alpha = alpha
        self.trainable_theta1 = nn.Linear(time_length, num_nodes)
        self.trainable_theta2 = nn.Linear(time_length, num_nodes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a1 = torch.tanh(self.alpha * self.trainable_theta1(x))
        a2 = torch.tanh(self.alpha * self.trainable_theta2(x))
        skew = (torch.einsum("bnd,bmd->bnm", a1, a2)
                - torch.einsum("bnd,bmd->bnm", a2, a1))
        return torch.relu(torch.tanh(self.alpha * skew))


class SCL(nn.Module):
    """Per-timestep two-layer GCN on scalar node features, dropout 0.5 and
    a width-1 convolution to one channel (models/RGCNU/Model.py:24-41)."""

    def __init__(self, hidden_dim: int):
        super().__init__()
        self.gcn1 = GCNLayer(1, hidden_dim, activation="none")
        self.gcn2 = GCNLayer(hidden_dim, hidden_dim, activation="none")
        self.dropout = nn.Dropout(0.5)
        self.conv1d = nn.Conv1d(hidden_dim, 1, 1)

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.gcn1(x, adj))
        h = self.dropout(torch.relu(self.gcn2(h, adj)))
        return self.conv1d(h.transpose(1, 2))       # (B*L, 1, N)


class TDL(nn.Module):
    """An LSTM over time on ``(B, L, N)`` (models/RGCNU/Model.py:44-51)."""

    def __init__(self, num_nodes: int, encoder_hidden_dim: int):
        super().__init__()
        self.lstm = LSTMLayer(num_nodes, encoder_hidden_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.lstm(x)[0]


class FusionModule(nn.Module):
    """The raw series through a width-1 convolution, plus the temporal
    features, through a 'same'-padded convolution of ``kernel_size`` and the
    two heads (models/RGCNU/Model.py:54-75). 'same' pads ``(k-1)//2`` on
    the left and ``k//2`` on the right, as the JAX package pads."""

    def __init__(self, num_nodes: int, time_length: int,
                 encoder_hidden_dim: int, kernel_size: int):
        super().__init__()
        h = encoder_hidden_dim
        self.cnn1 = nn.Conv1d(num_nodes, h, 1)
        self.cnn2 = nn.Conv1d(h, h, kernel_size, padding="same")
        self.fc1 = nn.Linear(h * time_length, 1)
        self.fc2 = nn.Linear(h * time_length, 1)

    def forward(self, x: torch.Tensor, temporal: torch.Tensor):
        m = self.cnn1(x) + temporal.transpose(1, 2)  # (B, H, L)
        m = self.cnn2(m).reshape(x.shape[0], -1)
        return self.fc1(m), self.fc2(m)


class RGCNU(nn.Module):
    """Input ``(B, N, L)`` -> ``(B, 1)``; ``(pred, std)`` in ``train()``
    mode. Takes the hparam bank's keyword arguments
    (``configs.hparams.model_hparams(dataset, sub_id, "RGCNU")``)."""

    def __init__(self, num_nodes: int, time_length: int, hidden_dim: int,
                 encoder_hidden_dim: int, kernel_size: int, alpha: float):
        super().__init__()
        self.adj = AdjConstruction(num_nodes, time_length, alpha)
        self.scl = SCL(hidden_dim)
        self.tdl = TDL(num_nodes, encoder_hidden_dim)
        self.fusion = FusionModule(num_nodes, time_length,
                                   encoder_hidden_dim, kernel_size)

    def forward(self, x: torch.Tensor):
        b, n, l = x.shape
        # The A.repeat(L, 1, 1) pairing: flat index k = b*L + l reads
        # A[k % B].
        adj = self.adj(x).repeat(l, 1, 1)                # (B*L, N, N)
        xt = x.transpose(1, 2).reshape(b * l, n, 1)
        spatial = self.scl(xt, adj).reshape(b, l, n)    # (B, L, N)
        pred, std = self.fusion(x, self.tdl(spatial))
        if self.training:
            return pred, std
        return pred
