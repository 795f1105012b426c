"""Dense graph-attention layers (counterpart of
``gnn_rul_tpu/nn/attention.py``).

The reference layers concatenate all N^2 pairs ``[Wh_i ; Wh_j]`` (e.g.
models/STAGNN/Model.py:53-60). The attention projection is linear, so its
weight ``a = [a1 ; a2]`` splits and ``e_ij = leaky_relu(Wh_i a1 + Wh_j a2 +
b)``: two rank-1 terms, no ``(B, N^2, 2d)`` tensor.

Where attention dropout is inactive (eval mode, or ``attn_drop.p == 0``)
the chain from the logits to the aggregation is ``ops/kernels/fused_gat.py``:
the CUDA kernel on the card, its plain version on the CPU, as the JAX layer
takes its fused path under the same condition. Otherwise the ``(N, N)``
panel is materialised and the dropout applies to it before the adjacency
mask. The node-sharded hook ``gat_fn`` and the ``fused=`` switch are not
ported (ROADMAP.md).
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.graphs import leaky_relu
from ..ops.kernels.fused_gat import fused_gat


class GraphAttentionLayer(nn.Module):
    """Reference GraphAttentionLayer (models/STAGNN/Model.py:26-60):
    ``h' = (dropout(softmax(e, axis=-1)) * adj) @ Wh``, under the
    reference's keys ``linear`` (Linear(in, d)) and ``attention``
    (Linear(2d, 1)). ``final_leaky_relu`` adds GAT_LSTM's leaky_relu on the
    output, at torch's default slope 0.01, not the attention slope."""

    def __init__(self, in_features: int, out_features: int,
                 dropout: float = 0.0, negative_slope: float = 0.1,
                 final_leaky_relu: bool = False):
        super().__init__()
        self.out_features = out_features
        self.negative_slope = negative_slope
        self.final_leaky_relu = final_leaky_relu
        self.linear = nn.Linear(in_features, out_features)
        self.attention = nn.Linear(2 * out_features, 1)
        self.attn_drop = nn.Dropout(dropout)

    def forward(self, h: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        d = self.out_features
        wh = self.linear(h)
        a = self.attention.weight[0]
        f1 = wh @ a[:d]
        f2 = wh @ a[d:]
        bias = self.attention.bias[0]
        if not self.training or self.attn_drop.p == 0.0:
            out = fused_gat(wh, f1, f2, adj, bias, self.negative_slope)
        else:
            e = leaky_relu(f1[..., :, None] + f2[..., None, :] + bias,
                           self.negative_slope)
            attn = self.attn_drop(torch.softmax(e, dim=-1)) * adj
            out = torch.einsum("...nm,...md->...nd", attn, wh)
        return leaky_relu(out) if self.final_leaky_relu else out


class GAT(nn.Module):
    """Multi-head GAT, the mean of the heads (models/STAGNN/Model.py:62-73);
    the heads are ``attention_{i}``, the reference's keys."""

    def __init__(self, in_features: int, out_features: int, num_heads: int,
                 dropout: float = 0.0):
        super().__init__()
        self.num_heads = num_heads
        for i in range(num_heads):
            self.add_module(f"attention_{i}", GraphAttentionLayer(
                in_features, out_features, dropout))

    def forward(self, x: torch.Tensor, adj: torch.Tensor) -> torch.Tensor:
        heads = [getattr(self, f"attention_{i}")(x, adj)
                 for i in range(self.num_heads)]
        return torch.stack(heads).mean(dim=0)
