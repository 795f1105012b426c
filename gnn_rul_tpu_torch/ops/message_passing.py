"""Dense message passing (counterpart of
``gnn_rul_tpu/ops/message_passing.py``)."""

from __future__ import annotations

from typing import Callable, List, Optional

import torch


def spmm(adj: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Batched dense aggregation ``A @ X``: ``(..., N, N) x (..., N, D)``."""
    return torch.einsum("...nm,...md->...nd", adj, x)


def khop_aggregate(adj: torch.Tensor, x: torch.Tensor, k: int,
                   spmm_fn: Optional[Callable] = None) -> List[torch.Tensor]:
    """``[A X, A^2 X, ..., A^k X]``, with ``A^j`` chained as ``A_ = A_ @ A``
    and then ``A_ @ X`` (reference models/FC_STGNN/Model_Base.py:89-94).
    ``spmm_fn(adj, x)`` replaces the product with X (the node-sharded
    engine, ``parallel/graph_partition.py``)."""
    agg = spmm_fn if spmm_fn is not None else spmm
    outs = []
    a_pow = adj
    for j in range(k):
        if j > 0:
            a_pow = torch.einsum("...nm,...mk->...nk", a_pow, adj)
        outs.append(agg(a_pow, x))
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
