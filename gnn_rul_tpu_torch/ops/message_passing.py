"""Dense message passing (counterpart of
``gnn_rul_tpu/ops/message_passing.py``; only what FC_STGNN needs so far)."""

from __future__ import annotations

import torch


def spmm(adj: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched dense aggregation ``A @ X``: ``(..., N, N) x (..., N, D)``."""
    return torch.einsum("...nm,...md->...nd", adj, x)
