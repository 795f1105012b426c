"""Dense adjacency construction (counterpart of ``gnn_rul_tpu/ops/graphs.py``;
only what FC_STGNN needs so far)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def dot_graph_from_mapped(h: torch.Tensor) -> torch.Tensor:
    """``A = softmax(leaky_relu(h h^T - 1e8 I), axis=-1) + I``.

    The ``-1e8`` on the diagonal (through leaky_relu it lands at ``-1e6``)
    pushes the self-similarity to ~0 under softmax; the identity is then
    added back (reference models/FC_STGNN/Model_Base.py:49-67).
    """
    n = h.shape[-2]
    eye = torch.eye(n, dtype=h.dtype, device=h.device)
    sim = torch.einsum("...nd,...md->...nm", h, h)
    sim = leaky_relu(sim - eye * 1e8)
    return torch.softmax(sim, dim=-1) + eye
