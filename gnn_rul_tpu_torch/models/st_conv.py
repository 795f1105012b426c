"""ST_Conv: parallel GCN and TCN branches fused by a learned gate
(counterpart of ``gnn_rul_tpu/models/st_conv.py``).

Reference ST_Conv_model (models/ST_Conv/Model.py:173-222). Its forward
evaluates the gate's two branches with the *layer-1* modules both times
(reference :180-182 against :205-209), so both evaluations share weights
and give the same values; the BatchNorm statistics (and
``num_batches_tracked``) are updated twice a training step, as in torch.
The reference also builds layer-2 modules that its forward never calls;
they are not built here, and ``STConv.UNCALLED`` names their keys so that
``train.checkpoint.load_model_dict`` drops them from a reference
checkpoint. Submodule names are the original torch reference's
(``gnn_rul_tpu/compat/torch_import.py::_map_st_conv``). No kernel of the
port runs in this model.
"""

from __future__ import annotations

import torch
from torch import nn

from ..nn.basic import BatchNormNCL
from ..nn.gnn_blocks import MPNNmk
from ..nn.tcn import TemporalConvNet
from ..ops.graphs import pearson_graph


class CNNLayer(nn.Module):
    """``Conv1d(padding="same")`` -> BN -> ReLU (models/ST_Conv/Model.py:
    58-71). At an even kernel torch's "same" pads ``(k-1)//2`` steps on the
    left and ``k//2`` on the right, as the JAX package pads explicitly."""

    def __init__(self, channels: int, kernel_size: int):
        super().__init__()
        self.conv = nn.Conv1d(channels, channels, kernel_size, padding="same")
        self.bn = BatchNormNCL(channels)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.conv(x)))


class STConv(nn.Module):
    """Input ``(B, N, L)`` -> ``(B, 1)``. Takes the hparam bank's keyword
    arguments (``configs.hparams.model_hparams(dataset, sub_id,
    "ST_Conv")``)."""

    # The key prefixes of the reference's layer-2 modules, which its forward
    # never calls. They follow the layer-1 names that the JAX importer reads
    # (gcn_layer_1, cnn_layer_1, tcn_layer_1); no reference checkpoint was
    # at hand to confirm them.
    UNCALLED = ("gcn_layer_2.", "cnn_layer_2.", "tcn_layer_2.")

    def __init__(self, num_nodes: int, time_length: int, kernel_size: int):
        super().__init__()
        self.gcn_layer_1 = MPNNmk(time_length, time_length, k=1)
        self.cnn_layer_1 = CNNLayer(num_nodes, kernel_size)
        self.tcn_layer_1 = TemporalConvNet(num_nodes, num_nodes, kernel_size)
        for name in ("theta1", "theta2", "theta3", "theta4"):
            setattr(self, name, nn.Parameter(torch.randn(1)))
        self.fc = nn.Linear(num_nodes * time_length, 1)

    def _branches(self, x: torch.Tensor):
        gcn = self.cnn_layer_1(self.gcn_layer_1(x, pearson_graph(x)))
        return gcn, self.tcn_layer_1(x)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        gcn, tcn = self._branches(x)
        # The second branch runs the SAME layer-1 modules (reference
        # :205-209).
        gcn2, tcn2 = self._branches(x)
        combined = (torch.tanh(self.theta1 * tcn + self.theta2 * gcn)
                    * torch.sigmoid(self.theta3 * tcn2 + self.theta4 * gcn2))
        return self.fc((combined + x).reshape(x.shape[0], -1))
