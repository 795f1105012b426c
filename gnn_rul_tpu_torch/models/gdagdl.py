"""GDAGDL: an STFT spectrogram graph thresholded by node importance, 3
graph-attention layers, an MLP autoencoder and an LSTM (counterpart of
``gnn_rul_tpu/models/gdagdl.py``).

Reference GDAGDL_model (models/GDAGDL/Model.py:66-170), under its keys
(``node_importance_linear``, ``gat_layers.{i}``, ``encoder``, ``decoder``,
``lstm``, ``linear``). Each patch's STFT magnitude gives ``nperseg // 2 +
1`` frequency-bin nodes of ``1 + patch_size // nperseg`` frames. The
reference's "PCC" (:func:`gdagdl_pcc`) weighs a linear score of each node
into its importance; the nodes of positive importance are joined
(:func:`high_nodes`, a step function of the importance, kept as a module
function so that a caller can replay another run's choices), so a node
that is not, and a whole patch graph whose nodes are all not, keeps an
all-zero row. Three ``GraphAttentionLayer``s at the attention's dropout of
0.5 (reference :78), each followed by ELU: one launch each of the
graph-attention kernel, a graph a patch, where the dropout is inactive
(eval, or a dropout of 0); a training forward takes the plain panel, as in
the JAX package. An MLP autoencoder over each patch's code, its
reconstruction error the auxiliary loss (weight 1 in the algorithm
table), then an LSTM over the patches (cuDNN's on the card) and the
``linear`` head.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.attention import GraphAttentionLayer
from ..nn.basic import MLP
from ..nn.recurrent import LSTMLayer
from ..ops.edge_count import record_edges
from ..parallel.data_axis import batch_mean
from ..signal.stft import stft_magnitude

THRESHOLD = 0.0  # the reference joins the nodes of importance > 0
ATTENTION_DROPOUT = 0.5  # models/GDAGDL/Model.py:78


def gdagdl_pcc(mag: torch.Tensor) -> torch.Tensor:
    """The reference's "PCC" of ``(B, N, f)`` node features -> ``(B, N, N)``
    (models/GDAGDL/Model.py:42-63), NOT a Pearson matrix: its second
    operand is the centered block read row-major as ``(B, f, N)``, not
    transposed, and the norms divide unguarded. Kept as the reference
    computes it, since the importance threshold reads these values."""
    b, n, f = mag.shape
    record_edges((b, n, n))
    c = mag - mag.mean(dim=-1, keepdim=True)
    dot = torch.matmul(c, c.reshape(b, f, n))
    norms = torch.sqrt(torch.sum(c * c, dim=-1))
    return dot / (norms[:, :, None] * norms[:, None, :])


def high_nodes(importance: torch.Tensor) -> torch.Tensor:
    """1 where a node's importance is above THRESHOLD, else 0."""
    return (importance > THRESHOLD).to(importance.dtype)


class GDAGDL(nn.Module):
    """Input ``(B, 1, num_patch * patch_size)`` -> ``(B, 1)``; in training
    mode ``(pred, reconstruction loss)``. Takes the hparam bank's keyword
    arguments; ``num_nodes`` and ``input_dim`` must be the STFT's bins and
    frames."""

    def __init__(self, num_patch: int, patch_size: int, num_nodes: int,
                 nperseg: int, input_dim: int, gat_layer_dim: Sequence[int],
                 lstm_hidden_dim: int, autoencoder_hidden_dim: int,
                 autoencoder_out_dim: int):
        super().__init__()
        bins, frames = nperseg // 2 + 1, 1 + patch_size // nperseg
        if (num_nodes, input_dim) != (bins, frames):
            raise ValueError(
                f"GDAGDL: num_nodes={num_nodes}, input_dim={input_dim}, but "
                f"nperseg={nperseg} at patch_size={patch_size} gives {bins} "
                f"bins of {frames} frames")
        self.num_patch, self.patch_size, self.nperseg = (num_patch,
                                                         patch_size, nperseg)
        self.node_importance_linear = nn.Linear(frames, 1)
        dims = [frames, *gat_layer_dim]
        self.gat_layers = nn.ModuleList(
            GraphAttentionLayer(i, o, dropout=ATTENTION_DROPOUT)
            for i, o in zip(dims, dims[1:]))
        ah, code = autoencoder_hidden_dim, bins * dims[-1]
        self.encoder = MLP(code, [ah, ah // 2, ah // 4, autoencoder_out_dim])
        self.decoder = MLP(autoencoder_out_dim, [ah // 4, ah // 2, ah, code])
        self.lstm = LSTMLayer(autoencoder_out_dim, lstm_hidden_dim)
        self.linear = nn.Linear(num_patch * lstm_hidden_dim, 1)

    def forward(self, x: torch.Tensor):
        b, t = x.shape[0], self.num_patch
        flat = x.reshape(b * t, self.patch_size)
        mag = stft_magnitude(flat, self.nperseg)     # (B*T, bins, frames)
        pcc = gdagdl_pcc(mag)
        importance = torch.matmul(pcc, self.node_importance_linear(mag))
        high = high_nodes(importance[..., 0])
        adj = high[..., :, None] * high[..., None, :]

        h = mag
        for gat in self.gat_layers:
            h = F.elu(gat(h, adj))
        y_o = h.reshape(b, t, -1)

        enc = self.encoder(y_o)
        recon = batch_mean((y_o - self.decoder(enc)) ** 2)
        lstm_out, _ = self.lstm(enc)
        pred = self.linear(lstm_out.reshape(b, -1))
        if self.training:
            return pred, recon
        return pred
