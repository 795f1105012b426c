"""STNet: an STFT spectrogram graph, a ChebNet stack, an MLP autoencoder
and an LSTM (counterpart of ``gnn_rul_tpu/models/stnet.py``).

Reference STNet_model (models/STNet/Model.py:43-170), under its keys. Each
patch's STFT magnitude gives ``nperseg // 2 + 1`` frequency-bin nodes with
``1 + patch_size // nperseg`` frames of features. A 1 x 1 ``Conv2d`` scores
each node from its (mean, max); the nodes scoring above 0.7 are joined
(:func:`high_nodes`, a step function of the score, kept as a module
function so that a caller can replay another run's choices). Three
``ChebNet`` layers (K = 3), an MLP autoencoder over each patch's code with
its reconstruction error as the auxiliary loss (weight 1 in the algorithm
table), and an LSTM over the patch codes (cuDNN's on the card). No kernel
of the port runs in this model.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from ..nn.basic import MLP
from ..nn.gnn_blocks import ChebNet
from ..nn.recurrent import LSTMLayer
from ..ops.edge_count import record_edges
from ..parallel.data_axis import batch_mean
from ..signal.stft import stft_magnitude

THRESHOLD = 0.7  # models/STNet/Model.py:133


def high_nodes(weights: torch.Tensor) -> torch.Tensor:
    """1 where a node's score is above THRESHOLD, else 0."""
    return (weights > THRESHOLD).to(weights.dtype)


class STNet(nn.Module):
    """Input ``(B, 1, num_patch * patch_size)`` -> ``(B, 1)``; in training
    mode ``(pred, reconstruction loss)``."""

    def __init__(self, num_patch: int, patch_size: int, num_nodes: int,
                 nperseg: int, input_dim: int, Cheb_layers: Sequence[int],
                 lstm_hidden_dim: int, autoencoder_hidden_dim: int):
        super().__init__()
        del num_nodes  # the STFT's bins
        self.num_patch, self.patch_size, self.nperseg = (num_patch,
                                                         patch_size, nperseg)
        bins = nperseg // 2 + 1
        self.cnn = nn.Conv2d(2, 1, 1)
        dims = [input_dim, *Cheb_layers]
        self.chebnets = nn.ModuleList(ChebNet(i, o, 3)
                                      for i, o in zip(dims, dims[1:]))
        code = bins * dims[-1]
        self.encoder = MLP(code, [autoencoder_hidden_dim] * 4)
        self.decoder = MLP(autoencoder_hidden_dim,
                           [autoencoder_hidden_dim] * 3 + [code])
        self.lstm = LSTMLayer(autoencoder_hidden_dim, lstm_hidden_dim)
        self.linear = nn.Linear(num_patch * lstm_hidden_dim, 1)

    def forward(self, x: torch.Tensor):
        b, t = x.shape[0], self.num_patch
        flat = x.reshape(b * t, self.patch_size)
        mag = stft_magnitude(flat, self.nperseg)     # (B*T, bins, frames)
        n, f = mag.shape[-2:]
        xg = mag.reshape(b, t, n, f)

        # The node score: Conv2d(2 -> 1, 1 x 1) on (mean, max) (:110-133).
        node_feats = torch.cat([xg.mean(dim=-1, keepdim=True),
                                xg.amax(dim=-1, keepdim=True)], dim=-1)
        weights = self.cnn(node_feats.permute(0, 3, 1, 2))[:, 0]  # (B,T,N)
        high = high_nodes(weights)
        record_edges(high.shape + (high.shape[-1],))
        adj = torch.clamp(high[..., :, None] * high[..., None, :], max=1.0)

        h = xg.reshape(b * t, n, f)
        adj = adj.reshape(b * t, n, n)
        for chebnet in self.chebnets:
            h = chebnet(h, adj)
        y_o = h.reshape(b, t, -1)

        enc = self.encoder(y_o)
        recon = batch_mean((y_o - self.decoder(enc)) ** 2)
        lstm_out, _ = self.lstm(enc)
        pred = self.linear(lstm_out.reshape(b, -1))
        if self.training:
            return pred, recon
        return pred
