"""FC-STGNN: fully-connected space-time GNN for RUL (counterpart of
``gnn_rul_tpu/models/fc_stgnn.py``).

  patchify -> per-(sample, patch, node) 1D-CNN encoder + Linear/BN
  -> sinusoidal PE over patches (base 100, dropout in train mode)
  -> two parallel space-time MPNN blocks (sliding window over patches,
     learned dot-product graph over window*N nodes, decay mask, 1-hop GCN,
     mean-pool over window time)
  -> concat -> 4-layer MLP -> (B, 1)

Submodule names are the original torch reference's, so ``state_dict()``
carries the reference keys (``gnn_rul_tpu/compat/torch_import.py`` reads
them). The dot-graph chain always goes through
``ops/kernels/fused_gnn.py``: the CUDA kernel on the card, its plain version
on the CPU.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from ..nn.basic import BatchNorm1d
from ..nn.encoders import FeatureExtractor1DCNNRUL
from ..ops.encoding import sinusoidal_encoding
from ..ops.graphs import leaky_relu
from ..ops.kernels.fused_gnn import fused_dot_graph_spmm
from ..ops.windows import decay_mask, patchify, sliding_time_windows


class _GraphConstruction(nn.Module):
    def __init__(self, dim: int):
        super().__init__()
        self.mapping = nn.Linear(dim, dim)


class _MPNN(nn.Module):
    """MPNN_mk_v2 with k=1: Linear(A @ X) -> BN."""

    def __init__(self, input_dim: int, output_dim: int):
        super().__init__()
        self.theta = nn.ModuleList([nn.Linear(input_dim, output_dim)])
        self.bn1 = BatchNorm1d(output_dim)


class GraphConvPoolMPNN(nn.Module):
    """One space-time MPNN scale (reference GraphConvpoolMPNN_block_v6,
    models/FC_STGNN/Model_Base.py:175-225): sliding windows over the patch
    axis -> learned dot graph over the ``window*N`` space-time nodes (built
    from the raw nodes) -> BN on the nodes -> decay-masked aggregation ->
    Linear -> BN -> leaky_relu -> mean over window time."""

    def __init__(self, input_dim: int, output_dim: int, num_node: int,
                 time_window: int, stride: int, decay: float = 0.7):
        super().__init__()
        self.output_dim = output_dim
        self.time_window = time_window
        self.stride = stride
        self.graph_construction = _GraphConstruction(input_dim)
        self.BN = BatchNorm1d(input_dim)
        self.MPNN = _MPNN(input_dim, output_dim)
        self.register_buffer("mask", decay_mask(num_node, time_window, decay),
                             persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # x: (B, T, N, F)
        w = sliding_time_windows(x, self.time_window, self.stride)
        b, nw, tw, n, f = w.shape
        nodes = w.reshape(b * nw, tw * n, f)
        h = self.graph_construction.mapping(nodes)
        nodes = self.BN(nodes)
        agg = fused_dot_graph_spmm(h, nodes, self.mask)
        out = self.MPNN.bn1(self.MPNN.theta[0](agg))
        out = leaky_relu(out)
        out = out.reshape(b, nw, tw, n, self.output_dim)
        return out.mean(dim=2)  # (B, nw, N, output_dim)


class _Head(nn.Module):
    def __init__(self, in_dim: int, hidden_dim: int):
        super().__init__()
        self.fc1 = nn.Linear(in_dim, 2 * hidden_dim)
        self.fc2 = nn.Linear(2 * hidden_dim, 2 * hidden_dim)
        self.fc3 = nn.Linear(2 * hidden_dim, hidden_dim)
        self.fc4 = nn.Linear(hidden_dim, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = torch.relu(self.fc1(x))
        x = torch.relu(self.fc2(x))
        x = torch.relu(self.fc3(x))
        return self.fc4(x)


class FCSTGNN(nn.Module):
    """Flagship aeroengine model. Input (B, num_node, L) -> (B, 1).

    Takes the hparam bank's keyword arguments
    (``configs.hparams.model_hparams(dataset, sub_id, "FC_STGNN")``);
    ``num_sequential`` and ``num_windows`` are accepted for that and unused,
    as in the JAX package.
    """

    def __init__(self, patch_size: int, num_patch: int, encoder_time_out: int,
                 encoder_hidden_dim: int, encoder_out_dim: int,
                 encoder_conv_kernel: int, hidden_dim: int,
                 num_sequential: int, num_node: int, num_windows: int,
                 decay: float = 0.7,
                 moving_window: Tuple[int, int] = (2, 2),
                 stride: Tuple[int, int] = (1, 2),
                 pe_dropout: float = 0.1):
        super().__init__()
        del num_sequential, num_windows
        self.patch_size = patch_size
        self.num_patch = num_patch
        feat = 2 * hidden_dim
        self.nonlin_map = FeatureExtractor1DCNNRUL(
            encoder_hidden_dim, encoder_out_dim, kernel_size=encoder_conv_kernel)
        self.nonlin_map2 = nn.Sequential(
            nn.Linear(encoder_out_dim * encoder_time_out, feat),
            BatchNorm1d(feat))
        self.register_buffer(
            "pe", sinusoidal_encoding(num_patch, feat, base=100.0),
            persistent=False)
        self.pe_dropout = nn.Dropout(pe_dropout)
        self.MPNN1 = GraphConvPoolMPNN(feat, hidden_dim, num_node,
                                       moving_window[0], stride[0], decay)
        self.MPNN2 = GraphConvPoolMPNN(feat, hidden_dim, num_node,
                                       moving_window[1], stride[1], decay)
        nw = sum((num_patch - w) // s + 1 for w, s in zip(moving_window, stride))
        self.fc = _Head(nw * num_node * hidden_dim, hidden_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        xp = patchify(x, self.num_patch, self.patch_size)  # (B, T, N, P)
        _, tlen, n, p = xp.shape
        # Each (sample, patch, node) patch is a 1-channel sequence.
        enc = self.nonlin_map(xp.reshape(b * tlen * n, 1, p))
        enc = self.nonlin_map2(enc.reshape(b * tlen * n, -1))
        enc = enc.reshape(b, tlen, n, -1) + self.pe[None, :, None, :]
        enc = self.pe_dropout(enc)
        out1 = self.MPNN1(enc)
        out2 = self.MPNN2(enc)
        feats = torch.cat([out1.reshape(b, -1), out2.reshape(b, -1)], dim=-1)
        return self.fc(feats)
