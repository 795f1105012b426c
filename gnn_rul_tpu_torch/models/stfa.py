"""STFA: fixed prior sensor graph + multi-head GAT + LSTM (counterpart of
``gnn_rul_tpu/models/stfa.py``).

Reference STFA_model (models/STFA/Model.py:81-126) with the hand-coded
14-sensor C-MAPSS prior graph (:61-77). Quirk preserved: the "ASE" weights
are a softmax over a singleton axis, so exactly 1.0, and the global feature
concatenated to the LSTM input is a vector of ones of length num_patch
(:113-120); the ``v`` projection gets a zero gradient but stays a parameter
(weight decay moves it). Submodule names are the original torch
reference's (``gnn_rul_tpu/compat/torch_import.py::_map_stfa``).

The GAT heads run on the ``(B * num_patch, 14, patch_size)`` patch graphs
with the one shared ``(14, 14)`` prior: ``num_heads`` launches of
``ops/kernels/fused_gat.py`` per forward where attention dropout is
inactive (eval mode, or dropout set to 0); training at the bank's dropout
0.2 takes the plain path with dropout and launches none.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.attention import GAT
from ..nn.recurrent import LSTMLayer

_CMAPSS_EDGES = [
    (1, 2), (1, 12), (1, 4), (1, 9), (1, 5), (1, 3),
    (2, 4), (2, 7), (2, 8), (2, 13), (3, 14), (3, 13),
    (3, 10), (3, 6), (4, 7), (4, 8), (5, 9), (5, 11),
    (6, 10), (7, 8), (8, 13), (9, 11),
]


def prior_knowledge_graph(dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The 22-edge symmetric prior over the 14 retained C-MAPSS sensors
    (models/STFA/Model.py:61-77), no self-loops."""
    adj = torch.zeros((14, 14), dtype=dtype)
    for i, j in _CMAPSS_EDGES:
        adj[i - 1, j - 1] = adj[j - 1, i - 1] = 1.0
    return adj


class STFA(nn.Module):
    """Input ``(B, 14, L)`` -> ``(B, 1)``; C-MAPSS only (the prior graph is
    hard-coded). Takes the hparam bank's keyword arguments
    (``configs.hparams.model_hparams(dataset, sub_id, "STFA")``);
    ``hidden_dim`` is accepted for that and unused, as in the JAX
    package."""

    def __init__(self, patch_size: int, num_patch: int, num_nodes: int,
                 hidden_dim: int, output_dim: int, encoder_hidden_dim: int,
                 num_heads: int, dropout: float):
        super().__init__()
        del hidden_dim
        self.patch_size = patch_size
        self.num_patch = num_patch
        self.gat = GAT(patch_size, output_dim, num_heads, dropout)
        self.v = nn.Linear(num_nodes * output_dim, 1)
        self.lstm = LSTMLayer(num_patch + num_nodes * output_dim,
                              encoder_hidden_dim)
        self.fc = nn.Linear(encoder_hidden_dim, 1)
        self.register_buffer("adj", prior_knowledge_graph(), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, _ = x.shape
        t, p = self.num_patch, self.patch_size
        xp = x.reshape(b, n, t, p).permute(0, 2, 1, 3).reshape(b * t, n, p)
        gat_out = torch.relu(self.gat(xp, self.adj))
        concat = gat_out.reshape(b, t, -1)                   # (B, T, N*out)
        # ASE: a softmax over a singleton axis, exactly 1.0.
        ase = torch.softmax(self.v(torch.tanh(concat)), dim=-1)
        global_feature = ase.reshape(b, 1, t).expand(b, t, t)
        final = torch.cat([global_feature, concat], dim=-1)
        lstm_out, _ = self.lstm(final)
        return self.fc(lstm_out[:, -1, :])
