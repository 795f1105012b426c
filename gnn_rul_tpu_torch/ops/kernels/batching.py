"""The seed axis of ``torch.func.vmap`` folded into the registered
operators' own axes, for their ``register_vmap`` rules.

Under vmap every seed runs the same operator on its own tensors. The rules
fold the seeds into the operator's batch axis (a graph, a batch column of
the recurrence) and stack the operand that one call shares today (the
dot-graph mask, W_hh, the attention's bias and shared adjacency) into a
leading group axis, group g serving the g-th equal slice of the batch, so
all seeds run in one launch of each kernel. A seed's batch is one slice,
so seed s, group g of an operand that was grouped already becomes group
``s * G + g``.
"""

from __future__ import annotations

from typing import Optional

import torch


def fold(t: torch.Tensor, dim: Optional[int], size: int,
         axis: int = 0) -> torch.Tensor:
    """``t`` with its vmapped axis ``dim`` folded into its axis ``axis``,
    seed-major (``(S, B, ...) -> (S * B, ...)`` at ``axis`` 0), and
    contiguous. An operand that is not mapped (``dim`` None) is repeated
    for each of the ``size`` seeds."""
    t = t.expand(size, *t.shape) if dim is None else t.movedim(dim, 0)
    return t.movedim(0, axis).flatten(axis, axis + 1).contiguous()


def unfold(t: torch.Tensor, size: int, axis: int = 0) -> torch.Tensor:
    """The inverse of :func:`fold` on an output: its axis ``axis`` split
    into ``(size, -1)``; the seeds are then at ``axis``."""
    return t.unflatten(axis, (size, -1))


def groups(t: torch.Tensor, dim: Optional[int], size: int,
           shared_dims: int) -> torch.Tensor:
    """A shared operand of ``shared_dims`` dimensions as one call, with an
    optional leading group axis, in the folded call: not mapped and not
    grouped, as it is (one for every seed); not mapped and grouped, its
    groups repeated for each seed; mapped, each seed's own, its groups
    folded after the seed."""
    if dim is None:
        if t.dim() == shared_dims:
            return t
        return t.repeat(size, *[1] * shared_dims).contiguous()
    t = t.movedim(dim, 0)
    return t.reshape(-1, *t.shape[t.dim() - shared_dims:]).contiguous()
