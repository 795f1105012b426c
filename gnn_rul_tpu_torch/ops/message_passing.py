"""Dense message passing (counterpart of
``gnn_rul_tpu/ops/message_passing.py``; only what FC_STGNN and LOGO need so
far)."""

from __future__ import annotations

from typing import List

import torch


def spmm(adj: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched dense aggregation ``A @ X``: ``(..., N, N) x (..., N, D)``."""
    return torch.einsum("...nm,...md->...nd", adj, x)


def khop_aggregate(adj: torch.Tensor, x: torch.Tensor,
                   k: int) -> List[torch.Tensor]:
    """``[A X, A^2 X, ..., A^k X]``, with ``A^j`` chained as ``A_ = A_ @ A``
    and then ``A_ @ X`` (reference models/FC_STGNN/Model_Base.py:89-94)."""
    outs = []
    a_pow = adj
    for j in range(k):
        if j > 0:
            a_pow = torch.einsum("...nm,...mk->...nk", a_pow, adj)
        outs.append(spmm(a_pow, x))
    return outs
