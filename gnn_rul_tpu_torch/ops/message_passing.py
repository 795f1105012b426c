"""Dense message passing (counterpart of
``gnn_rul_tpu/ops/message_passing.py``; ``khop_aggregate``'s ``spmm_fn``
hook comes with ``parallel/graph_partition.py``, ROADMAP.md)."""

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


def chebyshev_terms(adj: torch.Tensor, x: torch.Tensor,
                    k: int) -> List[torch.Tensor]:
    """The Chebyshev recursion's ``[T_0 x, ..., T_{k-1} x]``: ``T_0 = X``,
    ``T_1 = A X``, ``T_j = 2 A T_{j-1} - T_{j-2}`` (reference
    models/ASTGCNN/Model.py:205-222)."""
    terms = [x]
    if k > 1:
        terms.append(spmm(adj, x))
    for _ in range(2, k):
        terms.append(2.0 * spmm(adj, terms[-1]) - terms[-2])
    return terms
