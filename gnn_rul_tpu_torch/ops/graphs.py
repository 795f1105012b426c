"""Dense adjacency construction (counterpart of ``gnn_rul_tpu/ops/graphs.py``,
every function of it). Each constructor of an ``(..., N, N)`` panel records
its edges (``ops/edge_count.py``) where the JAX package's does."""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .edge_count import record_edges


def leaky_relu(x: torch.Tensor, negative_slope: float = 0.01) -> torch.Tensor:
    return F.leaky_relu(x, negative_slope)


def dot_graph_from_mapped(h: torch.Tensor) -> torch.Tensor:
    """``A = softmax(leaky_relu(h h^T - 1e8 I), axis=-1) + I``.

    The ``-1e8`` on the diagonal (through leaky_relu it lands at ``-1e6``)
    pushes the self-similarity to ~0 under softmax; the identity is then
    added back (reference models/FC_STGNN/Model_Base.py:49-67).
    """
    n = h.shape[-2]
    record_edges(h.shape[:-1] + (n,))
    eye = torch.eye(n, dtype=h.dtype, device=h.device)
    sim = torch.einsum("...nd,...md->...nm", h, h)
    sim = leaky_relu(sim - eye * 1e8)
    return torch.softmax(sim, dim=-1) + eye


def dot_graph(x: torch.Tensor) -> torch.Tensor:
    """The unparameterized dot-product graph of raw features, ``A =
    softmax(leaky_relu(x x^T - 1e8 I), -1) + I`` (reference
    models/HierCorrPool/Model_Base.py:11-25): :func:`dot_graph_from_mapped`
    on ``x`` itself."""
    return dot_graph_from_mapped(x)


def pearson_graph(x: torch.Tensor, eps: float = 1e-8) -> torch.Tensor:
    """Pearson correlation between the rows of ``x``: ``(..., N, L) ->
    (..., N, N)`` (reference models/LOGO/Model.py:17-35).

    ``eps`` is added to the denominator as the JAX package adds it, so a
    row of zero variance gives 0 where ``torch.corrcoef`` gives nan.
    """
    record_edges(x.shape[:-1] + (x.shape[-2],))
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
    record_edges(x.shape[:-1] + (x.shape[-2],))
    norm = torch.clamp(torch.sqrt(torch.sum(x * x, dim=-1)), min=eps)
    sim = torch.einsum("...nd,...md->...nm", x, x)
    return sim / (norm[..., :, None] * norm[..., None, :])


def pairwise_sq_dists(x: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances between the rows of ``x``: ``(..., N, D)
    -> (..., N, N)``, by the JAX package's ``a^2 + b^2 - 2ab`` expansion,
    clipped at 0."""
    record_edges(x.shape[:-1] + (x.shape[-2],))
    sq = torch.sum(x * x, dim=-1)
    inner = torch.einsum("...nd,...md->...nm", x, x)
    return torch.clamp(sq[..., :, None] + sq[..., None, :] - 2.0 * inner,
                       min=0.0)


def gaussian_graph(x: torch.Tensor) -> torch.Tensor:
    """``A = exp(-cdist(x, x))``, the euclidean (not squared) distance
    between the rows of ``x (..., N, D)`` (reference models/ASTGCNN/
    Model.py:184-195).

    The distances come from direct pairwise differences, as the JAX package
    computes them: ``torch.cdist`` takes the ``a^2 + b^2 - 2ab`` expansion
    on CUDA above 25 rows, which loses fp32 precision. The square root is
    taken through a double ``where``, so that the gradient on the diagonal
    (distance 0, where the root's derivative is infinite) is 0, the
    subgradient ``torch.cdist`` gives, and not nan."""
    record_edges(x.shape[:-1] + (x.shape[-2],))
    diff = x[..., :, None, :] - x[..., None, :, :]
    s = torch.sum(diff * diff, dim=-1)
    positive = s > 0
    safe = torch.where(positive, s, torch.ones_like(s))
    d = torch.where(positive, torch.sqrt(safe), torch.zeros_like(s))
    return torch.exp(-d)


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


def gaussian_topk_graph(x: torch.Tensor, k: int) -> torch.Tensor:
    """:func:`gaussian_graph` sparsified to each row's top-k by
    :func:`topk_mask` (reference models/STGNN/Model.py:8-25)."""
    a = gaussian_graph(x)
    return a * topk_mask(a, k)


def covariance_threshold_graph(x: torch.Tensor,
                               threshold: float) -> torch.Tensor:
    """``A = (cov > threshold)`` as float over the rows of ``(..., N, L)``,
    with the unbiased row covariance (reference models/STAGNN/Model.py:
    197-204), computed in the JAX order: centre, product, divide by
    ``L - 1``, compare. A step function: an entry whose covariance lies
    within rounding of the threshold can flip between two summation
    orders."""
    record_edges(x.shape[:-1] + (x.shape[-2],))
    xc = x - x.mean(dim=-1, keepdim=True)
    cov = torch.einsum("...nl,...ml->...nm", xc, xc) / (x.shape[-1] - 1)
    return (cov > threshold).to(x.dtype)


def add_self_loops(adj: torch.Tensor, weight: float = 1.0) -> torch.Tensor:
    """``A + weight * I`` over the last two axes."""
    n = adj.shape[-1]
    return adj + weight * torch.eye(n, dtype=adj.dtype, device=adj.device)


def sym_normalize(adj: torch.Tensor, eps: float = 0.0) -> torch.Tensor:
    """Symmetric normalization ``D^-1/2 A D^-1/2`` of a dense adjacency,
    the degree from the row sums clipped below at ``eps``, plus 1e-12
    under the root (reference GCNLayer, models/RGCNU/Model.py:7-21)."""
    deg = torch.sum(adj, dim=-1)
    d_inv_sqrt = torch.rsqrt(torch.clamp(deg, min=eps) + 1e-12)
    return adj * d_inv_sqrt[..., :, None] * d_inv_sqrt[..., None, :]
