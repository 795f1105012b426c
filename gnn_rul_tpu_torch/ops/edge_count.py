"""Edges processed per forward pass (counterpart of
``gnn_rul_tpu/ops/edge_count.py``).

Every dense adjacency or attention panel of shape ``(..., N, M)`` built in
a forward adds ``prod(shape)`` processed edges. The graph constructors
(``ops/graphs.py``), the graph-attention layer (``nn/attention.py``), the
dot-graph wrapper (``ops/kernels/fused_gnn.py``) and the few adjacencies a
model builds inline call :func:`record_edges` with the panel's shape, where
the JAX package calls it. :func:`edges_per_sample` counts one forward on
the ``meta`` device: shapes only, no arithmetic, and no kernel launches,
since the registered operators dispatch to their shape-only fakes there.
"""

from __future__ import annotations

import contextlib
import contextvars
import copy

import torch
from torch import nn

_COUNTER: contextvars.ContextVar = contextvars.ContextVar(
    "gnn_rul_tpu_torch_edge_counter", default=None)


def record_edges(shape) -> None:
    """Adds ``prod(shape)`` edges to the active counter; nothing where
    none is active. ``shape`` is the panel's whole shape, its batch-like
    leading axes included."""
    acc = _COUNTER.get()
    if acc is not None:
        n = 1
        for s in shape:
            n *= int(s)
        acc[0] += n


@contextlib.contextmanager
def count_edges():
    """Activates the counter; yields a one-element list whose ``[0]`` holds
    the running total."""
    acc = [0]
    token = _COUNTER.set(acc)
    try:
        yield acc
    finally:
        _COUNTER.reset(token)


def edges_per_sample(model: nn.Module, sample_x, batch: int = 2) -> int:
    """Edges per sample of one forward of ``model`` in train mode at
    ``batch`` rows shaped like ``sample_x``'s: a copy of the model on the
    ``meta`` device runs the forward on a ``meta`` input, so nothing is
    computed and no kernel launches. Static per (method, hparams): count
    once and reuse."""
    meta = copy.deepcopy(model).to("meta").train()
    x = torch.zeros((batch, *tuple(sample_x.shape[1:])), device="meta")
    with count_edges() as acc, torch.no_grad():
        meta(x)
    return acc[0] // batch
