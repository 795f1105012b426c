"""The data axis: a batch's rows split over ranks, and the operations that
reach across them.

Each batch of B rows is split over the S ranks of the ``data`` group in
contiguous blocks, the first ``B mod S`` ranks one row more (31 rows over
2 ranks: 16 and 15). A rank whose block is empty (B < S, the remainder
batch of 1 over 2 ranks) computes one stand-in row, the batch's first,
whose every contribution below weighs 0: it runs the same forward and
joins the same collectives as the others, so no rank waits on one that
skipped a collective.

:class:`RowShard` describes this rank's block; the engine opens
:func:`row_shard` around its forward. Every operation of the models that
reduces or recurs over the batch axis asks :func:`current` for it and is
made global (ROADMAP.md lists them):

  - BatchNorm in train mode (``nn/basic.py``) normalises by the global
    batch's mean and variance: each rank's mean and sum of squared
    deviations, gathered in one :func:`all_gather_stats`, combined by Chan's
    rule, the counts known from the blocks;
  - :class:`~..nn.basic.Dropout` keys each element by its index in the
    global batch (the block's first row times the elements of a row);
  - a recurrence along the rows (LOGO's, LOGO_bearing's and HAGCN's
    Bi-LSTM) runs over the global rows: :func:`global_rows` gathers them
    (:func:`gather_rows`), runs the block on them with no shard open and
    keeps this rank's rows;
  - a batch mean in a loss is this rank's share of it: :func:`batch_mean`
    (its rows' sum over the global count), and a term that is not linear in
    the rows (LOGO's ``sqrt(mean(A^2))``) is computed from the global sum
    and shared equally (:func:`global_mean`, :func:`share`).

The engine's loss is then this rank's share of the global loss, the shares
summing to it, and the gradients are summed over the ranks: the step of
the single process. The autograd rules of the collectives follow from
that: the all-reduce's backward is an all-reduce of the gradients, the
gather's an all-reduce of the global gradient, of which each rank keeps its
rows. Both use only ``all_reduce`` and ``all_gather``, which gloo takes on
CUDA tensors (it refuses point-to-point on them, ``graph_partition.py``).
On a group of one every collective is the identity.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
from typing import Callable, Iterator, List, Optional, Tuple

import torch
import torch.distributed as dist


def split_rows(total: int, size: int) -> List[Tuple[int, int]]:
    """``(start, count)`` of each of ``size`` contiguous blocks of
    ``total`` rows, the first ``total mod size`` one row more."""
    base, extra = divmod(total, size)
    out, start = [], 0
    for r in range(size):
        count = base + (r < extra)
        out.append((start, count))
        start += count
    return out


@dataclasses.dataclass(frozen=True)
class RowShard:
    """This rank's block of a batch of ``total`` rows over the ``size``
    ranks of ``group``: rows ``start : start + valid`` of it. ``rows`` is
    what the rank computes: ``valid``, or 1 (the stand-in row) where
    ``valid`` is 0."""

    group: Optional[dist.ProcessGroup]
    size: int
    coord: int
    total: int
    blocks: Tuple[Tuple[int, int], ...]

    @property
    def start(self) -> int:
        return self.blocks[self.coord][0]

    @property
    def valid(self) -> int:
        return self.blocks[self.coord][1]

    @property
    def rows(self) -> int:
        return max(self.valid, 1)

    @property
    def weight(self) -> float:
        """1, or 0 on a stand-in row."""
        return 1.0 if self.valid else 0.0

    @property
    def widest(self) -> int:
        """The largest block: every rank's rows pad to it for a gather."""
        return max(count for _, count in self.blocks)

    def local_index(self, device=None) -> torch.Tensor:
        """The positions of this rank's rows in the global batch (the
        stand-in row's is 0)."""
        if not self.valid:
            return torch.zeros(1, dtype=torch.long, device=device)
        return torch.arange(self.start, self.start + self.valid,
                            device=device)


def shard_of(total: int, group: Optional[dist.ProcessGroup]) -> RowShard:
    """This rank's block of a batch of ``total`` rows over ``group``."""
    size = dist.get_world_size(group)
    return RowShard(group, size, dist.get_rank(group), total,
                    tuple(split_rows(total, size)))


_SHARD: contextvars.ContextVar = contextvars.ContextVar(
    "gnn_rul_tpu_torch_row_shard", default=None)


@contextlib.contextmanager
def row_shard(shard: Optional[RowShard]) -> Iterator[None]:
    """Makes ``shard`` the current block inside the block of code (None:
    the rows are the whole batch)."""
    token = _SHARD.set(shard)
    try:
        yield
    finally:
        _SHARD.reset(token)


def current() -> Optional[RowShard]:
    """The block of the forward running now, or None outside a split
    batch."""
    return _SHARD.get()


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward sums the gradients likewise (each
    rank's loss a share of one loss)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        out = t.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


def all_reduce_sum(t: torch.Tensor,
                   group: Optional[dist.ProcessGroup]) -> torch.Tensor:
    """``t`` summed over ``group``, differentiably; ``t`` itself on a group
    of one."""
    if group is None or dist.get_world_size(group) == 1:
        return t
    return _AllReduceSum.apply(t, group)


def all_gather_blocks(t: torch.Tensor, group: dist.ProcessGroup
                      ) -> List[torch.Tensor]:
    """Every rank's ``t`` (of one shape on every rank), in rank order;
    not differentiable."""
    out = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, t.contiguous(), group=group)
    return out


class _AllGather(torch.autograd.Function):
    """Every rank's ``t`` (of one shape on every rank), stacked in rank
    order; the backward sums the gradient of the stack over the ranks and
    keeps this rank's slice."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return torch.stack(all_gather_blocks(t, group))

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[dist.get_rank(ctx.group)], None


def all_gather_stats(t: torch.Tensor, group) -> torch.Tensor:
    """``(ranks, *t.shape)``: every rank's ``t``, differentiably (one
    all-gather forward, one all-reduce backward)."""
    return _AllGather.apply(t, group)


class _GatherRows(torch.autograd.Function):
    """The global batch from each rank's valid rows; the backward sums the
    global gradient over the ranks and keeps this rank's rows (the
    stand-in row's gradient 0)."""

    @staticmethod
    def forward(ctx, t, shard: RowShard):
        ctx.shard = shard
        pad = shard.widest - t.shape[0]
        if pad > 0:
            t = torch.cat([t, t.new_zeros((pad, *t.shape[1:]))])
        blocks = all_gather_blocks(t[:shard.widest], shard.group)
        return torch.cat([b[:count] for b, (_, count)
                          in zip(blocks, shard.blocks)])

    @staticmethod
    def backward(ctx, g):
        shard = ctx.shard
        g = g.contiguous().clone()
        dist.all_reduce(g, group=shard.group)
        mine = g[shard.start:shard.start + shard.valid]
        if not shard.valid:
            mine = torch.zeros_like(g[:1])
        return mine, None


def gather_rows(t: torch.Tensor, shard: RowShard) -> torch.Tensor:
    """The global batch ``(total, ...)`` from each rank's ``(rows, ...)``,
    differentiably."""
    if shard.size == 1:
        return t
    return _GatherRows.apply(t, shard)


def take_rows(t: torch.Tensor, shard: RowShard) -> torch.Tensor:
    """This rank's rows (or its stand-in row) of a global ``(total, ...)``
    tensor."""
    if not shard.valid:
        return t[:1]
    return t[shard.start:shard.start + shard.valid]


def global_rows(fn: Callable[[torch.Tensor], torch.Tensor],
                x: torch.Tensor) -> torch.Tensor:
    """``fn`` (rows in, rows out, along axis 0) applied to the global batch
    of which ``x`` holds this rank's rows, and this rank's rows of its
    answer. Outside a split batch, ``fn(x)``. Inside ``fn`` no shard is
    open: its dropout draws the single process's mask over the global
    rows."""
    shard = current()
    if shard is None:
        return fn(x)
    with row_shard(None):
        out = fn(gather_rows(x, shard))
    return take_rows(out, shard)


def _per_row(t: torch.Tensor, shard: RowShard) -> int:
    return t.numel() // shard.rows


def batch_mean(t: torch.Tensor) -> torch.Tensor:
    """``t.mean()`` for a tensor whose leading axes are the batch's rows
    (outermost): inside a split batch, this rank's share of the global
    mean, its rows' sum over the global count; the shares sum to it."""
    shard = current()
    if shard is None:
        return torch.mean(t)
    return t.sum() * shard.weight / (_per_row(t, shard) * shard.total)


def mean_of_sum(total: torch.Tensor, count: int) -> torch.Tensor:
    """``total / count`` for ``total`` a sum over ``count`` items of the
    batch's rows (a whole number of items a row): inside a split batch,
    this rank's share of the global batch's ``total / count``."""
    shard = current()
    if shard is None:
        return total / count
    return total * shard.weight / (count // shard.rows * shard.total)


def global_mean(t: torch.Tensor) -> torch.Tensor:
    """``t.mean()`` over the global batch, on every rank alike (the sum
    all-reduced); for a term that is not linear in the rows. Pass its
    result through :func:`share` before adding it to a loss."""
    shard = current()
    if shard is None:
        return torch.mean(t)
    total = all_reduce_sum(t.sum() * shard.weight, shard.group)
    return total / (_per_row(t, shard) * shard.total)


def share(v: torch.Tensor) -> torch.Tensor:
    """This rank's equal share of a value every rank computed alike."""
    shard = current()
    return v if shard is None else v / shard.size
