"""LOGO: local-global correlation graphs with a GRU-style graph fusion
(counterpart of ``gnn_rul_tpu/models/logo.py``).

  global Pearson graph over the raw series + a learned dot-product graph
  per patch -> gated fusion of the two adjacencies -> MPNN -> 3-layer
  direction-summed Bi-LSTM -> MLP -> (B, 1)

Training adds the graph regularization loss, weighted by ``theta``
(reference models/LOGO/Model.py:56-71). Submodule names are the original
torch reference's, so ``state_dict()`` carries its keys
(``gnn_rul_tpu/compat/torch_import.py::_map_logo`` reads them).

The reference calls its batch_first Bi-LSTM on ``(num_node*num_patch, bs,
d)`` (models/LOGO/Model.py:245-251), so the recurrence runs along the
BATCH axis with the node-patches as its batch; the port keeps that
dataflow. The model's answer for a row therefore depends on the other rows
of its batch: under the data axis the Bi-LSTM runs over the global rows
(``parallel/data_axis.py::global_rows``), and the graph regularization's
means are the global batch's.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.basic import Dropout
from ..nn.gnn_blocks import MPNNmk
from ..nn.recurrent import LSTMParams, bilstm_fused
from ..ops.graphs import dot_graph_from_mapped, leaky_relu, pearson_graph
from ..parallel.data_axis import batch_mean, global_mean, global_rows, share
from ..telemetry import span


class GraphAttenBlock(nn.Module):
    """GRU-style fusion gate on adjacencies (models/LOGO/Model.py:163-196):

    z = sig(W_Z_T A_T + W_Z_G A_G); r = sig(W_R_T A_T + W_R_G A_G);
    A_hat = tanh(W_h_T A_G + W_h r); A = (1 - z) A_T + z A_hat;
    then a -1e8 diagonal, a softmax over rows and + I.
    """

    def __init__(self, num_node: int):
        super().__init__()
        n = num_node
        self.W_Z_T, self.W_Z_G = nn.Linear(n, n), nn.Linear(n, n)
        self.W_R_T, self.W_R_G = nn.Linear(n, n), nn.Linear(n, n)
        self.W_h_T, self.W_h = nn.Linear(n, n), nn.Linear(n, n)

    def forward(self, a_t: torch.Tensor, a_g: torch.Tensor) -> torch.Tensor:
        z = torch.sigmoid(self.W_Z_T(a_t) + self.W_Z_G(a_g))
        r = torch.sigmoid(self.W_R_T(a_t) + self.W_R_G(a_g))
        a_hat = torch.tanh(self.W_h_T(a_g) + self.W_h(r))
        a = (1.0 - z) * a_t + z * a_hat
        eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
        return torch.softmax(a - eye * 1e8, dim=-1) + eye


class BiLSTMStandard(nn.Module):
    """3-layer direction-summed Bi-LSTM (models/LOGO/Model.py:75-126).

    Widths [h, 2h, h]; the two directions' outputs are summed after each
    layer; dropout 0.2 after layers 2 and 3 (the reference defines a drop1
    it never applies); a final leaky_relu. Each layer's weights carry
    ``nn.LSTM``'s names on ``bi_lstm{1,2,3}``; the recurrences run through
    :func:`bilstm_fused`, not ``nn.LSTM``.
    """

    def __init__(self, input_dim: int, num_hidden: int):
        super().__init__()
        h = num_hidden
        self.bi_lstm1 = LSTMParams(input_dim, h, bidirectional=True)
        self.bi_lstm2 = LSTMParams(h, 2 * h, bidirectional=True)
        self.bi_lstm3 = LSTMParams(2 * h, h, bidirectional=True)
        self.drop2 = Dropout(0.2)
        self.drop3 = Dropout(0.2)

    @staticmethod
    def _bi(layer: LSTMParams, x: torch.Tensor) -> torch.Tensor:
        f, b, _ = bilstm_fused(x, layer.direction(), layer.direction(True))
        return f + b

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self._bi(self.bi_lstm1, x)
        x = self.drop2(self._bi(self.bi_lstm2, x))
        x = self.drop3(self._bi(self.bi_lstm3, x))
        return leaky_relu(x)


def graph_regularization_loss(x: torch.Tensor, adj: torch.Tensor,
                              gamma: float = 1.0) -> torch.Tensor:
    """mean(||x_i - x_j||^2 * A_ij) + gamma * sqrt(mean(A^2))
    (models/LOGO/Model.py:56-71), the means over the batch's graphs: under
    the data axis, this rank's share of the global batch's value."""
    diff = x[..., :, None, :] - x[..., None, :, :]
    dist = torch.sum(diff * diff, dim=-1)
    return batch_mean(dist * adj) \
        + gamma * share(torch.sqrt(global_mean(adj * adj)))


class _Head(nn.Module):
    def __init__(self, in_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, 16)
        self.fc2 = nn.Linear(16, 8)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.fc2(torch.relu(self.fc1(x))))


class LOGOCore(nn.Module):
    """The LOGO trunk on node features ``(B, T, N, D)`` and a per-sample
    global adjacency ``(B, N, N)``; LOGO_bearing shares it after its signal
    front end (models/LOGO_bearing/Model.py:263-348). Returns ``(B, 1)``,
    and ``(pred, gl_loss)`` in ``train()`` mode."""

    def __init__(self, input_dim: int, hidden_dim: int, num_nodes: int,
                 num_patch: int, gamma: float = 1.0, spmm_fn=None):
        super().__init__()
        self.gamma = gamma
        self.nonlin_map = nn.Linear(input_dim, 2 * input_dim)
        self.graph_attn_blk = GraphAttenBlock(num_nodes)
        self.MPNN = MPNNmk(2 * input_dim, 3 * input_dim, k=1,
                           spmm_fn=spmm_fn)
        self.TD = BiLSTMStandard(3 * input_dim, 3 * hidden_dim)
        self.fc = _Head(num_nodes * num_patch * 3 * hidden_dim)
        self.cls = nn.Linear(8, 1)

    def trunk(self, xp: torch.Tensor, global_corr: torch.Tensor):
        b, t, n, d = xp.shape
        with span("logo.graphs"):
            nodes = xp.reshape(b * t, n, d)
            mapped = self.nonlin_map(nodes)
            local_corr = dot_graph_from_mapped(mapped)
            g = global_corr[:, None].expand(b, t, n, n).reshape(b * t, n, n)
            fused = self.graph_attn_blk(local_corr, g)
        with span("logo.mpnn"):
            mp = self.MPNN(mapped, fused)
        # (B, T*N, d) -> (T*N, B, d), fed to a batch_first Bi-LSTM: the
        # recurrence runs over the B rows (the global batch's).
        with span("logo.encoder"):
            td = global_rows(
                lambda z: self.TD(z.transpose(0, 1)).transpose(0, 1),
                mp.reshape(b, n * t, -1))
        with span("logo.head"):
            out = self.cls(self.fc(td.reshape(b, -1)))
        if self.training:
            return out, graph_regularization_loss(nodes, fused, self.gamma)
        return out


class LOGO(LOGOCore):
    """Input ``(B, N, L)`` -> ``(B, 1)``; ``(pred, gl_loss)`` in
    ``train()`` mode. Takes the hparam bank's keyword arguments
    (``configs.hparams.model_hparams(dataset, sub_id, "LOGO")``);
    ``spmm_fn`` replaces the MPNN's ``A @ X`` (the node-sharded engine,
    ``parallel/graph_partition.py``)."""

    def __init__(self, patch_size: int, num_patch: int, num_nodes: int,
                 hidden_dim: int, gamma: float = 1.0, spmm_fn=None):
        super().__init__(patch_size, hidden_dim, num_nodes, num_patch, gamma,
                         spmm_fn)
        self.patch_size = patch_size
        self.num_patch = num_patch

    def forward(self, x: torch.Tensor):
        b, n, _ = x.shape
        global_corr = pearson_graph(x)
        xp = x.reshape(b, n, self.num_patch, self.patch_size).permute(
            0, 2, 1, 3)  # (B, T, N, P)
        return self.trunk(xp, global_corr)
