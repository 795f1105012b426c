"""Dense adjacency construction (counterpart of ``gnn_rul_tpu/ops/graphs.py``;
only what FC_STGNN, LOGO, HAGCN, STAGNN and STGNN need so far).
``record_edges`` waits for ``ops/edge_count.py`` (ROADMAP.md)."""

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


def pearson_graph(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Pearson correlation between the rows of ``x``: ``(..., N, L) ->
    (..., N, N)`` (reference models/LOGO/Model.py:17-35).

    ``eps`` is added to the denominator as the JAX package adds it, so a
    row of zero variance gives 0 where ``torch.corrcoef`` gives nan.
    """
    xc = x - x.mean(dim=-1, keepdim=True)
    cov = torch.einsum("...nl,...ml->...nm", xc, xc)
    var = torch.sqrt(torch.clamp(torch.einsum("...nl,...nl->...n", xc, xc),
                                 min=0.0))
    denom = var[..., :, None] * var[..., None, :]
    return cov / (denom + eps)


def cosine_graph(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Pairwise cosine similarity of the rows of ``x``: ``(..., N, D) ->
    (..., N, N)``, each norm clamped below at ``eps`` as
    ``F.cosine_similarity`` clamps it (reference models/HAGCN/Model.py:
    122-127)."""
    norm = torch.clamp(torch.sqrt(torch.sum(x * x, dim=-1)), min=eps)
    sim = torch.einsum("...nd,...md->...nm", x, x)
    return sim / (norm[..., :, None] * norm[..., None, :])


def pairwise_sq_dists(x: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances between the rows of ``x``: ``(..., N, D)
    -> (..., N, N)``, by the JAX package's ``a^2 + b^2 - 2ab`` expansion,
    clipped at 0."""
    sq = torch.sum(x * x, dim=-1)
    inner = torch.einsum("...nd,...md->...nm", x, x)
    return torch.clamp(sq[..., :, None] + sq[..., None, :] - 2.0 * inner,
                       min=0.0)


def top_indices(scores: torch.Tensor, k: int) -> torch.Tensor:
    """The indices of the ``k`` largest of each row of ``scores (..., N)``,
    in descending order, the lower index first among equal scores, as
    ``jax.lax.top_k`` orders them. ``torch.topk`` keeps other indices among
    ties (on the CPU, torch 2.13), so a stable sort takes its place."""
    return torch.sort(scores, dim=-1, descending=True,
                      stable=True).indices[..., :k]


def topk_mask(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Row-wise top-k 0/1 mask of ``(..., N, N)`` scores: ``scores >= kth``
    with kth each row's k-th largest, so an entry tied with it is kept too
    (more than k in a row), as the JAX ``topk_mask`` keeps it. A step
    function: a score within rounding of the k-th can fall on the other
    side on another device."""
    kth = torch.topk(scores, k, dim=-1).values[..., -1:]
    return (scores >= kth).to(scores.dtype)


def covariance_threshold_graph(x: torch.Tensor,
                               threshold: float) -> torch.Tensor:
    """``A = (cov > threshold)`` as float over the rows of ``(..., N, L)``,
    with the unbiased row covariance (reference models/STAGNN/Model.py:
    197-204), computed in the JAX order: centre, product, divide by
    ``L - 1``, compare. A step function: an entry whose covariance lies
    within rounding of the threshold can flip between two summation
    orders."""
    xc = x - x.mean(dim=-1, keepdim=True)
    cov = torch.einsum("...nl,...ml->...nm", xc, xc) / (x.shape[-1] - 1)
    return (cov > threshold).to(x.dtype)
