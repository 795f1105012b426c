"""HAGCN: Bi-LSTM node encoder, cosine graph, three GIN + SAGPool (top-k)
stages (counterpart of ``gnn_rul_tpu/models/hagcn.py``).

Reference HAGCN_model (models/HAGCN/Model.py:129-195). Training adds the
summed KL(prior || score) of the three SAGPool layers, which the algorithm
weights by ``alpha``. Submodule names are the original torch reference's,
so ``state_dict()`` carries its keys
(``gnn_rul_tpu/compat/torch_import.py::_map_hagcn`` reads them).

The reference transposes the Bi-LSTM's input to ``(num_patch, B*N, patch)``
and then runs a batch_first LSTM on it (models/HAGCN/Model.py:157-162), so
the recurrence runs along the ``B*N`` axis with the patches as its batch;
the port keeps that dataflow. Its three layers (widths h, 2h, h) run
through ``ops/kernels/fused_lstm.py`` at T = 14 * B and B = num_patch: 3
launches per forward on the card. The model's answer for a row therefore
depends on the other rows of its batch.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.graphs import cosine_graph, leaky_relu, top_indices
from ..ops.message_passing import spmm
from ..parallel.data_axis import global_rows, mean_of_sum
from ..telemetry import span
from .logo import BiLSTMStandard


def _mlp(in_dim: int, hidden: int, out_dim: int) -> nn.Sequential:
    """``Linear, ReLU, Linear`` under the keys ``0`` and ``2``."""
    return nn.Sequential(nn.Linear(in_dim, hidden), nn.ReLU(),
                         nn.Linear(hidden, out_dim))


class GINLayer(nn.Module):
    """``mlp(A X + (1 + eps) X)`` with a learnable scalar ``eps`` of shape
    (1,) (models/HAGCN/Model.py:6-24)."""

    def __init__(self, input_dim: int, hidden_dim: int):
        super().__init__()
        self.eps = nn.Parameter(torch.zeros(1))
        self.mlp = _mlp(input_dim, hidden_dim, hidden_dim)

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        return self.mlp(spmm(adj, x) + (1.0 + self.eps[0]) * x)


class SAGPool(nn.Module):
    """Score-based top-``n`` pooling with the KL(prior || score) auxiliary
    loss (models/HAGCN/Model.py:75-120). ``(x (G, N, D), adj (G, N, N)) ->
    (x (G, n, out), adj (G, n, n), kl)``.

    The score is ``softmax(rank(A X))`` over the nodes and the prior
    ``softmax(mlp(X))``; the KL is ``F.kl_div(P.log(), score, "batchmean")``,
    so its sum is divided by G (HAGCN's B * num_patch). The kept nodes are
    the ``n`` of highest score, the lower index first among equal scores
    (``ops/graphs.py::top_indices``, as ``jax.lax.top_k``); their order does
    not change the model's answer (each later stage is equivariant to it
    and the means invariant), but which nodes are kept is a step function
    of the scores.
    """

    def __init__(self, input_dim: int, output_dim: int, n: int):
        super().__init__()
        self.n = n
        self.model = nn.Linear(input_dim, output_dim)
        self.rank = nn.Linear(input_dim, 1)
        self.mlp = _mlp(input_dim, input_dim // 2, 1)

    def forward(self, x: torch.Tensor, adj: torch.Tensor):
        ax = spmm(adj, x)
        x_out = leaky_relu(self.model(ax))
        p = torch.softmax(self.mlp(x), dim=1)[..., 0]
        score = torch.softmax(self.rank(ax), dim=1)[..., 0]
        kl = mean_of_sum(torch.sum(torch.xlogy(score, score)
                                   - score * torch.log(p)), x.shape[0])
        top = top_indices(score, self.n)                        # (G, n)
        x_sel = torch.gather(
            x_out, 1, top[..., None].expand(-1, -1, x_out.shape[-1]))
        a_rows = torch.gather(
            adj, 1, top[..., None].expand(-1, -1, adj.shape[-1]))
        a_sel = torch.gather(a_rows, 2,
                             top[:, None, :].expand(-1, self.n, -1))
        return x_sel, a_sel, kl


class HAGCN(nn.Module):
    """Input ``(B, N, L)`` -> ``(B, 1)``; ``(pred, kl1 + kl2 + kl3)`` in
    ``train()`` mode. Takes the hparam bank's keyword arguments
    (``configs.hparams.model_hparams(dataset, sub_id, "HAGCN")``)."""

    def __init__(self, patch_size: int, num_patch: int,
                 encoder_hidden_dim: int, hidden_dim: int, output_dim: int):
        super().__init__()
        self.patch_size = patch_size
        self.num_patch = num_patch
        h = hidden_dim
        self.TD = BiLSTMStandard(patch_size, encoder_hidden_dim)
        self.gin1 = GINLayer(encoder_hidden_dim, h)
        self.gnn1 = SAGPool(h, h, 10)
        self.gin2 = GINLayer(h, h)
        self.gnn2 = SAGPool(h, h, 5)
        self.gin3 = GINLayer(h, h)
        self.gnn3 = SAGPool(h, h, 1)
        self.fc = _mlp(num_patch * 3 * h, output_dim, 1)

    def forward(self, x: torch.Tensor):
        b, n, _ = x.shape
        t, p = self.num_patch, self.patch_size
        # (B*N, T, P) -> (T, B*N, P), fed to a batch_first Bi-LSTM: the
        # recurrence runs over the B*N rows (the global batch's).
        with span("hagcn.encoder"):
            td = global_rows(lambda z: self.TD(
                z.reshape(-1, t, p).transpose(0, 1)).transpose(0, 1).reshape(
                    z.shape[0], n, t, -1), x)
        with span("hagcn.graph"):
            nodes = td.transpose(1, 2).reshape(b * t, n, -1)  # (B*T, N, H)
            adj0 = cosine_graph(nodes, eps=1e-12)

        with span("hagcn.stage1"):
            out1, a1, kl1 = self.gnn1(self.gin1(nodes, adj0), adj0)
        with span("hagcn.stage2"):
            out2, a2, kl2 = self.gnn2(self.gin2(out1, a1), a1)
        with span("hagcn.stage3"):
            out3, _, kl3 = self.gnn3(self.gin3(out2, a2), a2)

        with span("hagcn.head"):
            cat = torch.cat([out1.mean(dim=1), out2.mean(dim=1),
                             out3.mean(dim=1)], dim=-1).reshape(b, -1)
            out = self.fc(cat)
        if self.training:
            return out, kl1 + kl2 + kl3
        return out
