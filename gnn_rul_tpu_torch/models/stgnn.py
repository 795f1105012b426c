"""STGNN: per-patch gaussian top-k graphs, ChebNet and a per-node GRU
(counterpart of ``gnn_rul_tpu/models/stgnn.py``).

Reference STGNN_model (models/STGNN/Model.py:64-107): patchify, ``A =
topk(exp(-cdist^2))`` per patch, ChebNet over the nodes, a GRU per node
over the patches, and a Linear on the whole flattened GRU output.
Submodule names are the original torch reference's
(``gnn_rul_tpu/compat/torch_import.py::_map_stgnn``). The top-k is a step
function of the similarities (``ops/graphs.py::topk_mask``). No kernel of
the port runs in this model.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.gnn_blocks import ChebNet
from ..nn.recurrent import GRULayer
from ..ops.graphs import pairwise_sq_dists, topk_mask
from ..ops.windows import patchify


class STGNN(nn.Module):
    """Input ``(B, N, L)`` -> ``(B, 1)``. Takes the hparam bank's keyword
    arguments (``configs.hparams.model_hparams(dataset, sub_id,
    "STGNN")``)."""

    def __init__(self, patch_size: int, num_patch: int, num_nodes: int,
                 hidden_dim: int, K: int, top_k: int):
        super().__init__()
        self.patch_size = patch_size
        self.num_patch = num_patch
        self.top_k = top_k
        self.chebnet = ChebNet(patch_size, hidden_dim, K)
        self.gru = GRULayer(hidden_dim, hidden_dim)
        self.fc = nn.Linear(num_nodes * num_patch * hidden_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        xp = patchify(x, self.num_patch, self.patch_size)   # (B, T, N, P)
        _, t, n, p = xp.shape
        # The gaussian kernel on the SQUARED distance (models/STGNN/
        # Model.py:13-16), then each row's top-k.
        flat = xp.reshape(b * t, n, p)
        sim = torch.exp(-pairwise_sq_dists(flat))
        adj = sim * topk_mask(sim, self.top_k)
        cheb = self.chebnet(flat, adj)                        # (B*T, N, H)
        seq = cheb.reshape(b, t, n, -1).transpose(1, 2).reshape(b * n, t, -1)
        out, _ = self.gru(seq)
        return self.fc(out.reshape(b, -1))
