"""The dense graph algebra split by node rows over the mesh's ``model``
ranks (counterpart of ``gnn_rul_tpu/parallel/graph_partition.py``).

Each engine takes what the local computation takes and returns what it
returns, the full ``(B, N, F)`` on every rank of the ``model`` group. Rank
m of k owns the contiguous node block ``m * N/k : (m + 1) * N/k`` (N padded
up to a multiple of k where the engine allows it): it builds the block's
adjacency rows ``(B, N/k, N)`` and their aggregation, so no rank holds the
whole ``(N, N)`` panel; the output blocks are gathered into the full
answer (one ``all_gather``). The ranks of the group hold the same inputs,
since the rest of the model runs whole on each of them, so each reads the
remote nodes' features from its own copy; the ring engine instead passes
the blocks around the ring, one at a time.

The gradient follows from that layout (every rank's loss is the same):
the gathered output's backward keeps this rank's block of the gradient;
an input every rank reads whole gets this rank's part of its gradient,
summed over the group (one ``all_reduce``); an input read by row blocks
gets its blocks' gradients gathered: the rules of
``parallel/model_axis.py``, which the tensor-parallel layers share.

Padding is as in JAX: zero rows and columns for ``A @ X``, and -1e30 on
the attention's padded columns before its softmax. The attention's dropout
inside :func:`node_sharded_gat` keys its mask on the rank (the stream is
another than the local layer's, as JAX documents).

NCCL takes every collective here on CUDA tensors. Gloo takes
``all_reduce`` and ``all_gather`` on them but not point-to-point (on an
H100, a gloo ``send`` of a CUDA tensor ends its process), so the ring's
transfers are staged through pinned host buffers where the group's backend
is gloo and the tensors are on the card (:func:`_exchange`).

None of these engines launches a port kernel: they are plain tensor code,
as the JAX ones reach no ``pallas_call``.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from . import data_axis
from .model_axis import (copy_to_model as _replicated,
                         gather_from_model as _gather_blocks,
                         slice_to_model as _row_block)

NEG = -1e30  # the attention's padded columns


def _pad_nodes(t: torch.Tensor, pad: int, dims) -> torch.Tensor:
    """``t`` with ``pad`` zero rows appended on each axis of ``dims``."""
    if not pad:
        return t
    widths = [0] * (2 * t.dim())
    for d in dims:
        widths[2 * (t.dim() - 1 - (d % t.dim())) + 1] = pad
    return F.pad(t, widths)


def spmm_hook_kwargs(method: str, mesh, axis: str = "model") -> Dict:
    """The constructor keyword that routes ``method``'s graph algebra
    through a node-sharded engine over ``axis`` (the trainer passes it when
    the mesh's model axis is above 1):

      - FC_STGNN: the dot-graph chain with its decay mask,
        ``spmm_fn(h, nodes, mask=...)`` (:func:`node_sharded_dot_graph_spmm`);
      - LOGO, LOGO_bearing, HierCorrPool, HierCorrPool_bearing: ``A @ X``
        on an adjacency the model built, ``spmm_fn(adj, x)``
        (:func:`node_sharded_spmm`);
      - GAT_LSTM, STFA: the attention panel, ``gat_fn(...)``
        (:func:`node_sharded_gat`).
    """
    if method == "FC_STGNN":
        return {"spmm_fn": functools.partial(
            node_sharded_dot_graph_spmm, mesh=mesh, axis=axis)}
    if method in ("LOGO", "LOGO_bearing", "HierCorrPool",
                  "HierCorrPool_bearing"):
        return {"spmm_fn": functools.partial(
            node_sharded_spmm, mesh=mesh, axis=axis)}
    if method in ("GAT_LSTM", "STFA"):
        return {"gat_fn": functools.partial(
            node_sharded_gat, mesh=mesh, axis=axis)}
    raise ValueError(f"no node-sharded hook for method {method!r}")


def node_sharded_spmm(adj: torch.Tensor, x: torch.Tensor, mesh,
                      axis: str = "model") -> torch.Tensor:
    """``A @ X`` with the node rows split over ``axis``: ``adj`` ``(B, N,
    N)`` or ``(N, N)``, ``x`` ``(B, N, D)`` -> ``(B, N, D)``. N is padded
    to a multiple of the axis with zero rows and columns, which only make
    padded outputs (dropped)."""
    group = mesh.get_group(axis)
    k = dist.get_world_size(group)
    b, n, _ = x.shape
    if adj.dim() == 2:
        adj = adj.expand(b, n, n)
    pad = -(-n // k) * k - n
    a_blk = _row_block(_pad_nodes(adj, pad, (1, 2)), group, 1)
    x_all = _replicated(_pad_nodes(x, pad, (1,)), group)
    out = _gather_blocks(torch.einsum("bnm,bmd->bnd", a_blk, x_all), group, 1)
    return out[:, :n] if pad else out


def node_sharded_gat(wh: torch.Tensor, f1: torch.Tensor, f2: torch.Tensor,
                     adj: torch.Tensor, bias, negative_slope: float, mesh,
                     axis: str = "model", dropout=None) -> torch.Tensor:
    """The dense attention panel with its query rows split over ``axis``:
    ``e_ij = leaky_relu(f1_i + f2_j + bias)``, ``attn = dropout(softmax_j
    (e)) * adj``, ``out = attn @ wh``; ``wh`` ``(B, N, D)``, ``f1, f2``
    ``(B, N)``, ``adj`` ``(B, N, N)`` or ``(N, N)``. Each rank builds its
    ``(N/k, N)`` panel. Rows are padded to a multiple of the axis, padded
    columns set to -1e30 before the softmax. ``dropout`` is the layer's
    :class:`~..nn.basic.Dropout` (its mask keyed on this rank, another
    stream than the local layer's) or None."""
    group = mesh.get_group(axis)
    k, m = dist.get_world_size(group), dist.get_rank(group)
    b, n, _ = wh.shape
    if adj.dim() == 2:
        adj = adj.expand(b, n, n)
    n_pad = -(-n // k) * k
    pad = n_pad - n
    f1_blk = _row_block(_pad_nodes(f1, pad, (1,)), group, 1)
    a_blk = _row_block(_pad_nodes(adj, pad, (1, 2)), group, 1)
    f2_all = _replicated(_pad_nodes(f2, pad, (1,)), group)
    wh_all = _replicated(_pad_nodes(wh, pad, (1,)), group)
    if isinstance(bias, torch.Tensor):
        bias = _replicated(bias, group)   # a parameter: its gradient summed
    e = F.leaky_relu(f1_blk[:, :, None] + f2_all[:, None, :] + bias,
                     negative_slope)
    if pad:
        cols = torch.arange(n_pad, device=e.device) >= n
        e = e.masked_fill(cols, NEG)
    attn = torch.softmax(e, dim=-1)
    if dropout is not None:
        attn = dropout(attn, fold=m)
    out = _gather_blocks(torch.einsum("bnm,bmd->bnd", attn * a_blk, wh_all),
                         group, 1)
    return out[:, :n] if pad else out


def _dot_graph_rows(x_blk: torch.Tensor, x_cols: torch.Tensor,
                    row0: int, col0: int) -> torch.Tensor:
    """``leaky_relu(x_blk x_cols^T - 1e8 I, 0.01)`` for rows ``row0 ...``
    and columns ``col0 ...`` of the full matrix (the -1e8 on the global
    diagonal)."""
    s = torch.einsum("bnd,bmd->bnm", x_blk, x_cols)
    rows = row0 + torch.arange(x_blk.shape[1], device=s.device)
    cols = col0 + torch.arange(x_cols.shape[1], device=s.device)
    eye = (rows[:, None] == cols[None, :]).to(s.dtype)
    return F.leaky_relu(s - eye * 1e8, 0.01), eye


def node_sharded_dot_graph_spmm(x: torch.Tensor, v: torch.Tensor, mesh,
                                axis: str = "model",
                                mask: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """``((softmax(leaky_relu(x x^T - 1e8 I, 0.01)) + I) * mask) @ v`` with
    the node rows split over ``axis``: ``x`` ``(B, N, D)`` the similarity
    features, ``v`` ``(B, N, F)`` the values, ``mask`` ``(N, N)`` applied
    after the softmax (FC_STGNN's decay mask) or None. N must be divisible
    by the axis."""
    group = mesh.get_group(axis)
    k, m = dist.get_world_size(group), dist.get_rank(group)
    n = x.shape[1]
    if n % k:
        raise ValueError(f"N={n} is not divisible by the {axis} axis of {k}")
    blk = n // k
    z, eye = _dot_graph_rows(_row_block(x, group, 1), _replicated(x, group),
                             m * blk, 0)
    a = torch.softmax(z, dim=-1) + eye
    if mask is not None:
        a = a * mask.expand(n, n)[m * blk:(m + 1) * blk]
    out = torch.einsum("bnm,bmf->bnf", a, _replicated(v, group))
    return _gather_blocks(out, group, 1)


def _exchange(send: torch.Tensor, group, dst: int, src: int) -> torch.Tensor:
    """``send`` to group rank ``dst``, and the tensor of the same shape
    from group rank ``src``, by ``batch_isend_irecv``. Where the group's
    backend is gloo and the tensors are on the card, both go through pinned
    host buffers (gloo takes no point-to-point on CUDA tensors)."""
    staged = (send.is_cuda
              and dist.get_backend(group) == dist.Backend.GLOO)
    out = send if not staged else send.to("cpu", non_blocking=False)
    recv = torch.empty_like(out, pin_memory=staged)
    if staged:
        out = out.pin_memory()
    ops = [dist.P2POp(dist.isend, out.contiguous(),
                      dist.get_global_rank(group, dst), group),
           dist.P2POp(dist.irecv, recv, dist.get_global_rank(group, src),
                      group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(send.device, non_blocking=staged) if staged else recv


class _Ring(torch.autograd.Function):
    """The ring's forward on this rank's row block; its backward recomputes
    the block's rows from the inputs every rank holds (no ring)."""

    @staticmethod
    def forward(ctx, x, v, mask, group):
        ctx.group = group
        ctx.save_for_backward(x, v, mask)
        k, m = dist.get_world_size(group), dist.get_rank(group)
        blk = x.shape[1] // k
        x_blk = x[:, m * blk:(m + 1) * blk].contiguous()
        v_blk = v[:, m * blk:(m + 1) * blk].contiguous()
        b = x.shape[0]
        acc = x.new_zeros((b, blk, v.shape[-1]))
        run_max = x.new_full((b, blk, 1), float("-inf"))
        norm = x.new_zeros((b, blk, 1))
        x_rot, v_rot = x_blk, v_blk
        for step in range(k):
            # After `step` hops this rank holds the block of rank m - step.
            src = (m - step) % k
            z, _ = _dot_graph_rows(x_blk, x_rot, m * blk, src * blk)
            new_max = torch.maximum(run_max, z.amax(dim=-1, keepdim=True))
            p = torch.exp(z - new_max)
            scale = torch.exp(run_max - new_max)
            # The normaliser spans every column; the mask multiplies after
            # the softmax, so only the values see it.
            pv = p if mask is None else \
                p * mask[m * blk:(m + 1) * blk, src * blk:(src + 1) * blk]
            acc = acc * scale + torch.einsum("bnm,bmf->bnf", pv, v_rot)
            norm = norm * scale + p.sum(dim=-1, keepdim=True)
            run_max = new_max
            if step + 1 < k:
                x_rot = _exchange(x_rot, group, (m + 1) % k, (m - 1) % k)
                v_rot = _exchange(v_rot, group, (m + 1) % k, (m - 1) % k)
        out = acc / norm
        if mask is None:
            return out + v_blk
        diag = torch.diagonal(mask[m * blk:(m + 1) * blk,
                                   m * blk:(m + 1) * blk])
        return out + diag[None, :, None] * v_blk

    @staticmethod
    def backward(ctx, g):
        x, v, mask = ctx.saved_tensors
        group = ctx.group
        k, m = dist.get_world_size(group), dist.get_rank(group)
        blk = x.shape[1] // k
        with torch.enable_grad():
            xd, vd = x.detach().requires_grad_(), v.detach().requires_grad_()
            z, eye = _dot_graph_rows(xd[:, m * blk:(m + 1) * blk], xd,
                                     m * blk, 0)
            a = torch.softmax(z, dim=-1) + eye
            if mask is not None:
                a = a * mask[m * blk:(m + 1) * blk]
            out = torch.einsum("bnm,bmf->bnf", a, vd)
            dx, dv = torch.autograd.grad(out, (xd, vd), g)
        return dx, dv, None, None


def ring_dot_graph_spmm(x: torch.Tensor, v: torch.Tensor, mesh,
                        axis: str = "model",
                        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`node_sharded_dot_graph_spmm`'s answer by a ring: each rank
    keeps its own row block of ``x`` and passes the key and value blocks
    ``(x, v)`` around the ring, one block at a time
    (``batch_isend_irecv``), folding each into an online softmax (a running
    row max and normaliser, the accumulator rescaled as blocks arrive), so
    no rank forms a ``(N/k, N)`` score panel. The backward
    (:class:`_Ring`) recomputes the rank's rows from the inputs. N must be
    divisible by the axis."""
    group = mesh.get_group(axis)
    k = dist.get_world_size(group)
    n = x.shape[1]
    if n % k:
        raise ValueError(f"N={n} is not divisible by the {axis} axis of {k}")
    m_full = None if mask is None else mask.expand(n, n).contiguous()
    out = _Ring.apply(_replicated(x, group), _replicated(v, group), m_full,
                      group)
    return _gather_blocks(out, group, 1)
