"""DVGTformer: a dual (temporal and spatial) graph-prior transformer
(counterpart of ``gnn_rul_tpu/models/dvgtformer.py``).

Reference DVGTformer_model (models/DVGTformer/Model.py:113-174). A virtual
node and a virtual time step are appended; the Pearson correlation of the
*embedded* input is each attention's prior, mixed into the softmax scores
by ``lambda``; temporal and spatial transformer blocks alternate.

Kept as the reference has them:
  - the positional encoding's exponent is ``2i/d`` with ``i`` the raw even
    index (not ``i/2``), and its last column stays zero when ``d`` is odd
    (:143-149);
  - the attention applies a SECOND softmax over the mixed scores (:59,
    :103);
  - the residuals add the block's input *after* the sublayer's LayerNorm;
  - the temporal block applies dropout after its residual; the spatial
    block defines dropout and never applies it (:64 against :106-110).

The exact GELU is ``nn.basic.GELU``, whose fp32 tail is JAX's where
``torch.nn.GELU``'s cancels. The attention is plain einsum and softmax:
neither the prior's mix nor the second softmax is a function
``scaled_dot_product_attention`` computes, and the JAX package reaches no
TPU kernel here. ``nn.LayerNorm`` keeps
torch's epsilon, 1e-5, which the reference trained with; flax's default,
which the JAX package takes, is 1e-6 (ROADMAP.md, Queue 3). Submodule
names are the original torch reference's
(``gnn_rul_tpu/compat/torch_import.py::_map_dvgtformer``). No kernel of
the port runs in this model.
"""

from __future__ import annotations

import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from ..nn.basic import GELU, Dropout
from ..ops.graphs import pearson_graph


def positional_encoding(n: int, d_model: int) -> np.ndarray:
    """The reference's loop (models/DVGTformer/Model.py:143-149) in
    float64: ``pe[pos, i] = sin(pos / 10000^(2i/d))`` and ``pe[pos, i+1] =
    cos(...)`` for even ``i < d - 1``; the last column of an odd ``d``
    stays zero."""
    pe = np.zeros((n, d_model))
    for pos in range(n):
        for i in range(0, d_model - 1, 2):
            pe[pos, i] = np.sin(pos / (10000 ** ((2 * i) / d_model)))
            pe[pos, i + 1] = np.cos(pos / (10000 ** ((2 * i) / d_model)))
    return pe


class VGTBlock(nn.Module):
    """One graph-prior transformer block (TVGTformer or SVGTformer,
    models/DVGTformer/Model.py:26-110) on tokens of ``model_dim`` features,
    its submodules named with ``tag`` (``temp`` or ``spat``) as the
    reference names them: ``linears_{Q,K,V}_<tag>.<head>``,
    ``W_O_<tag>``, ``layer_norm{1,2}_<tag>``, ``feed_forward_<tag>``. The
    heads' projections are computed as one stacked product each, as the
    JAX package computes them. Dropout only where ``apply_dropout``."""

    def __init__(self, tag: str, model_dim: int, d_model: int,
                 num_heads: int, lambda_param: float, d_ff: int,
                 dropout: float, apply_dropout: bool):
        super().__init__()
        self.tag = tag
        self.d_model, self.num_heads = d_model, num_heads
        self.lambda_param = lambda_param
        for qkv in "QKV":
            self.add_module(f"linears_{qkv}_{tag}", nn.ModuleList(
                nn.Linear(model_dim, d_model) for _ in range(num_heads)))
        self.add_module(f"W_O_{tag}", nn.Linear(num_heads * d_model,
                                                model_dim))
        self.add_module(f"layer_norm1_{tag}", nn.LayerNorm(model_dim))
        self.add_module(f"layer_norm2_{tag}", nn.LayerNorm(model_dim))
        self.add_module(f"feed_forward_{tag}", nn.Sequential(
            nn.Linear(model_dim, d_ff), GELU(), nn.Linear(d_ff, model_dim)))
        self.dropout = Dropout(dropout) if apply_dropout else None

    def _sub(self, name: str) -> nn.Module:
        return getattr(self, f"{name}_{self.tag}")

    def _heads(self, qkv: str, x: torch.Tensor) -> torch.Tensor:
        """Every head's projection of ``x (B, N, model_dim)`` as one
        product: ``(B, heads, N, d_model)``."""
        linears = self._sub(f"linears_{qkv}")
        w = torch.stack([lin.weight for lin in linears])   # (H, d_model, in)
        b = torch.stack([lin.bias for lin in linears])     # (H, d_model)
        return torch.einsum("bnd,hmd->bhnm", x, w) + b[None, :, None]

    def forward(self, x: torch.Tensor, a_prior: torch.Tensor) -> torch.Tensor:
        prior = torch.softmax(torch.relu(a_prior), dim=-1)
        q, k, v = (self._heads(qkv, x) for qkv in "QKV")
        scores = torch.einsum("bhnd,bhmd->bhnm", q, k) / math.sqrt(
            self.d_model)
        attn = ((1.0 - self.lambda_param) * torch.softmax(scores, dim=-1)
                + self.lambda_param * prior[:, None])
        # The reference applies softmax AGAIN over the mixed attention.
        attn = torch.softmax(attn, dim=-1)
        heads = torch.einsum("bhnm,bhmd->bhnd", attn, v)
        # The heads concatenated in order: (B, N, H * d_model).
        cat = heads.transpose(1, 2).reshape(x.shape[0], x.shape[1], -1)
        out = self._sub("layer_norm1")(self._sub("W_O")(cat)) + x
        if self.dropout is not None:
            out = self.dropout(out)
        ff = self._sub("feed_forward")(out)
        return self._sub("layer_norm2")(ff) + out


class DVGTformer(nn.Module):
    """Input ``(B, N, L)`` -> ``(B, 1)``. Takes the hparam bank's keyword
    arguments (``configs.hparams.model_hparams(dataset, sub_id,
    "DVGTformer")``)."""

    def __init__(self, num_nodes: int, time_length: int,
                 d_model: Sequence[int], num_heads: int, lambda_param: float,
                 d_ff: Sequence[int], dropout: float, num_blocks: int):
        super().__init__()
        self.num_nodes, self.time_length = num_nodes, time_length
        self.linear_t = nn.Linear(time_length, time_length)
        self.linear_x = nn.Linear(num_nodes, num_nodes)
        self.t_v = nn.Parameter(torch.randn(1, 1, num_nodes))
        self.x_v = nn.Parameter(torch.randn(1, time_length + 1, 1))
        # Not in the state_dict: the reference's keys do not include it.
        self.register_buffer("pe", torch.as_tensor(positional_encoding(
            time_length + 1, num_nodes + 1), dtype=torch.float32),
            persistent=False)
        self.tvgtformer_blocks = nn.ModuleList(
            VGTBlock("temp", num_nodes + 1, d_model[0], num_heads,
                     lambda_param, d_ff[0], dropout, apply_dropout=True)
            for _ in range(num_blocks))
        self.svgtformer_blocks = nn.ModuleList(
            VGTBlock("spat", time_length + 1, d_model[1], num_heads,
                     lambda_param, d_ff[1], dropout, apply_dropout=False)
            for _ in range(num_blocks))
        self.output_layer = nn.Sequential(
            nn.Linear((time_length + 1) * (num_nodes + 1), 100), GELU(),
            nn.Linear(100, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        h = self.linear_x(self.linear_t(x).transpose(-1, -2))   # (B, L, N)
        h = torch.cat([h, self.t_v.expand(b, 1, self.num_nodes)], dim=1)
        h = torch.cat([h, self.x_v.expand(b, self.time_length + 1, 1)],
                      dim=-1)                                   # (B, L+1, N+1)
        a_temp = pearson_graph(h)                               # (B, L+1, L+1)
        a_spat = pearson_graph(h.transpose(-1, -2))             # (B, N+1, N+1)
        h = h + self.pe[None]
        for temporal, spatial in zip(self.tvgtformer_blocks,
                                     self.svgtformer_blocks):
            h = temporal(h, a_temp).transpose(1, 2)
            h = spatial(h, a_spat).transpose(1, 2)
        return self.output_layer(h.reshape(b, -1))
