"""HierCorrPool: a CNN over the patches, a correlation graph and soft
cluster pooling (counterpart of ``gnn_rul_tpu/models/hiercorrpool.py``).

Reference HierCorrPool_model (models/HierCorrPool/Model.py:6-52,
Model_Base.py). Patches are flattened into (B, N*patch) channel rows, run
through a 3-block strided CNN, regrouped as (B, N, eck*embedding) node
features (the reshape crosses the time and channel axes exactly as the
reference's ``reshape([bs, eck, N, -1])`` does), then: the unparameterized
dot graph -> soft cluster-assignment pooling -> MPNN -> MLP head.
Submodule names are the original torch reference's
(``gnn_rul_tpu/compat/torch_import.py::_hiercorrpool_core``), whose keys
are flat where the JAX package's tree sits under ``core``. The
``spmm_fn`` hook takes the node-sharded ``A @ X`` of
``parallel/graph_partition.py`` under a model axis above 1. No kernel of
the port runs in this model.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..nn.encoders import FeatureExtractor1DCNN
from ..nn.gnn_blocks import MPNNmk
from ..ops.graphs import dot_graph
from ..ops.message_passing import spmm
from ..ops.windows import patchify


class ClusterAssignment(nn.Module):
    """Soft cluster-assignment matrix (models/HierCorrPool/Model_Base.py:
    102-117): ``S = softmax(W [A ; sigmoid(Lin(A X))])`` over the NODE
    axis, so each cluster's column sums to 1 over the nodes."""

    def __init__(self, in_features: int, num_nodes: int, hidden_dim: int,
                 out_nodes: int, spmm_fn=None):
        super().__init__()
        self.spmm_fn = spmm_fn if spmm_fn is not None else spmm
        self.dimension_mapping = nn.Linear(in_features, hidden_dim)
        self.matrix = nn.Linear(num_nodes + hidden_dim, out_nodes)

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        h = torch.sigmoid(self.dimension_mapping(self.spmm_fn(adj, x)))
        s = self.matrix(torch.cat([adj, h], dim=-1))
        return torch.softmax(s, dim=-2)


class GraphClassificationBlock(nn.Module):
    """Pool, then pass messages (models/HierCorrPool/Model_Base.py:122-145):
    ``X' = S^T X``, ``A' = S^T A S``, then a 1-hop MPNN on them."""

    def __init__(self, in_features: int, num_nodes: int, out_dim: int,
                 out_nodes: int, spmm_fn=None):
        super().__init__()
        self.Graph_Clustering = ClusterAssignment(in_features, num_nodes,
                                                  out_nodes, out_nodes,
                                                  spmm_fn)
        self.Message_Passing = MPNNmk(in_features, out_dim, k=1,
                                      spmm_fn=spmm_fn)

    def forward(self, adj: torch.Tensor, x: torch.Tensor):
        s = self.Graph_Clustering(x, adj)
        st = s.transpose(-1, -2)
        x_pool = torch.matmul(st, x)
        # Two products: a three-operand einsum's path search (opt_einsum)
        # reads the sizes and would fix the batch of an exported program.
        a_pool = torch.matmul(torch.matmul(st, adj), s)
        return a_pool, self.Message_Passing(x_pool, a_pool)


class HierCorrPool(nn.Module):
    """Input ``(B, N, L)`` -> ``(B, 1)``. Takes the hparam bank's keyword
    arguments (``configs.hparams.model_hparams(dataset, sub_id,
    "HierCorrPool")``); ``input_dim`` is the reference's and unused, as it
    is there. ``spmm_fn(adj, x)`` replaces the graph block's ``A @ X``
    products (the node-sharded engine, ``parallel/graph_partition.py``)."""

    def __init__(self, patch_size: int, num_patch: int, input_dim: int,
                 hidden_dim: int, embedding_dim: int, num_nodes: int,
                 encoder_conv_kernel: int, num_nodes_out: int,
                 encoder_kernel_size: int = 8, spmm_fn=None):
        super().__init__()
        del input_dim
        self.patch_size, self.num_patch = patch_size, num_patch
        self.eck = encoder_conv_kernel
        self.Time_Preprocessing = FeatureExtractor1DCNN(
            num_nodes * patch_size, hidden_dim * num_nodes,
            kernel_size=encoder_kernel_size, stride=1, dropout=0.35)
        # Each node's features after the regrouping: the encoder's
        # T' x 4*hidden*N values a window over the N nodes.
        steps = self.Time_Preprocessing.out_length(num_patch)
        node_dim = steps * 4 * hidden_dim
        if node_dim % encoder_conv_kernel:
            raise ValueError(
                f"HierCorrPool: {steps} encoder steps x {4 * hidden_dim} "
                f"channels a node do not regroup into encoder_conv_kernel="
                f"{encoder_conv_kernel} parts")
        self.gc1 = GraphClassificationBlock(
            node_dim, num_nodes, embedding_dim * encoder_conv_kernel * 3,
            num_nodes_out, spmm_fn)
        self.fc_0 = nn.Linear(
            num_nodes_out * embedding_dim * encoder_conv_kernel * 3,
            embedding_dim * 3)
        self.fc_1 = nn.Linear(embedding_dim * 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.trunk(patchify(x, self.num_patch, self.patch_size))

    def trunk(self, xp: torch.Tensor) -> torch.Tensor:
        """Node features ``(B, T, N, D)`` -> ``(B, 1)``: everything after
        the front end (the JAX ``HierCorrPoolCore``), shared with
        HierCorrPool_bearing."""
        b, _, n, _ = xp.shape
        td_in = xp.reshape(b, self.num_patch, -1).transpose(1, 2)
        td_out = self.Time_Preprocessing(td_in).transpose(1, 2)
        # The reference's regrouping (Model.py:38-42): flatten (T', C), then
        # regroup as (eck, N, -1), which crosses the time and channel axes.
        gc = td_out.reshape(b, self.eck, n, -1).transpose(1, 2).reshape(
            b, n, -1)
        _, out = self.gc1(dot_graph(gc), gc)
        h = F.leaky_relu(self.fc_0(out.reshape(b, -1)), 0.01)
        return F.leaky_relu(self.fc_1(h), 0.01)
