"""Recurrent layers (counterpart of ``gnn_rul_tpu/nn/recurrent.py``).

Gates in torch's order, [i, f, g, o] for the LSTM and [r, z, n] for the
GRU, whose ``n = tanh(W_in x + b_in + r * (W_hn h + b_hn))``; weights
U(-1/sqrt(H), 1/sqrt(H)), as ``torch.nn.LSTM`` and ``torch.nn.GRU``
initialise them. Input ``(B, T, D)`` (batch_first).

:func:`bilstm_fused` projects the input of both directions with one plain
product each and runs the whole recurrence of both directions through
``ops/kernels/fused_lstm.py``: the CUDA kernels on the card, at every T,
and their plain versions on the CPU. The JAX package's scan, its unroll
policy and its scan/Pallas dispatch are XLA and TPU scheduling facts and
have no counterpart here.

:class:`LSTMLayer` and :class:`GRULayer`, the single-direction layers, are
``torch.nn.LSTM`` and ``torch.nn.GRU``: their JAX counterparts are
``lax.scan`` loops that reach no Pallas kernel, so no kernel of the port
replaces them. The multi-layer :class:`LSTM` runs a bidirectional layer
through :func:`bilstm_fused` (the kernels), as the JAX ``LSTM`` runs it
through its fused path, and a unidirectional one through cuDNN;
:class:`GRU` is ``torch.nn.GRU``.

Under ``torch.func.vmap`` (seed-parallel runs, ``train/vectorized.py``)
the library's LSTM and GRU have no batching rule, so these layers then call
the registered operator ``gnn_rul_tpu_torch::library_rnn``
(:data:`library_rnn`): plumbing around the same library call, not a
kernel. Its vmap rule runs each seed's call in turn, since each seed has
its own weights; its backward recomputes the call and differentiates it.
Outside vmap the layers run ``torch.nn.LSTM``'s and ``torch.nn.GRU``'s own
forward, as before.

At bf16 (``--precision bf16``) the card's cuDNN takes no bf16 RNN
(``torch.backends.cudnn.is_acceptable`` is False for a bf16 tensor on the
H100): ``torch.nn.LSTM`` and ``torch.nn.GRU`` then run PyTorch's own CUDA
recurrence in bf16, a cuBLAS product and an elementwise cell kernel a
step, as the JAX layers' ``lax.scan`` runs at bf16. :func:`bilstm_fused`
runs the recurrence kernels' bf16 instantiation.
"""

from __future__ import annotations

import math
import warnings
from typing import List, Sequence, Tuple

import torch
from torch import nn

from ..ops.kernels.fused_lstm import lstm_recurrence

Params = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]


class LSTMParams(nn.Module):
    """Parameter-only LSTM layer (counterpart of ``_LSTMParams``): the
    weights of a one-layer ``torch.nn.LSTM`` under its own names,
    ``weight_ih_l0 (4H, D)``, ``weight_hh_l0 (4H, H)``, ``bias_ih_l0``,
    ``bias_hh_l0`` and, when ``bidirectional``, their ``_reverse`` twins,
    so that a reference ``state_dict`` loads as it is. It runs no
    recurrence: :meth:`direction` hands one direction's weights to
    :func:`bilstm_fused`."""

    def __init__(self, input_size: int, hidden_size: int,
                 bidirectional: bool = False):
        super().__init__()
        self.hidden_size = hidden_size
        g = 4 * hidden_size
        for sfx in ("", "_reverse") if bidirectional else ("",):
            for name, shape in (("weight_ih_l0", (g, input_size)),
                                ("weight_hh_l0", (g, hidden_size)),
                                ("bias_ih_l0", (g,)), ("bias_hh_l0", (g,))):
                self.register_parameter(name + sfx,
                                        nn.Parameter(torch.empty(shape)))
        self.reset_parameters()

    def reset_parameters(self) -> None:
        bound = 1.0 / math.sqrt(self.hidden_size)
        for p in self.parameters():
            nn.init.uniform_(p, -bound, bound)

    def direction(self, reverse: bool = False) -> Params:
        """``(w_ih (D, 4H), w_hh (H, 4H), b_ih, b_hh)`` in the JAX layout."""
        sfx = "_reverse" if reverse else ""
        return (getattr(self, "weight_ih_l0" + sfx).t(),
                getattr(self, "weight_hh_l0" + sfx).t(),
                getattr(self, "bias_ih_l0" + sfx),
                getattr(self, "bias_hh_l0" + sfx))


def bilstm_fused(x: torch.Tensor, params_fwd: Params, params_bwd: Params):
    """Both directions of one LSTM layer over ``x (B, T, D)``.

    ``params_*`` are ``(w_ih (D, 4H), w_hh (H, 4H), b_ih, b_hh)``. Returns
    ``ys_fwd, ys_bwd`` (each ``(B, T, H)``) and the final states
    ``((h_fwd, c_fwd), (h_bwd, c_bwd))``, each ``(B, H)``: the contract of
    the JAX ``bilstm_fused``.
    """
    w_ih_f, w_hh_f, b_ih_f, b_hh_f = params_fwd
    w_ih_b, w_hh_b, b_ih_b, b_hh_b = params_bwd
    # The input projections, outside the recurrence; the backward
    # direction's sequence is flipped so that step i consumes T-1-i.
    xg_f = (torch.matmul(x, w_ih_f) + b_ih_f + b_hh_f).transpose(0, 1)
    xg_b = (torch.matmul(x, w_ih_b) + b_ih_b + b_hh_b).transpose(0, 1)
    xg = torch.stack([xg_f, xg_b.flip(0)], dim=1)   # (T, 2, B, 4H)
    w_hh = torch.stack([w_hh_f, w_hh_b])            # (2, H, 4H)
    ys, c_fin = lstm_recurrence(xg, w_hh)
    ys_f = ys[:, 0].transpose(0, 1)                 # (B, T, H)
    ys_b = ys[:, 1].flip(0).transpose(0, 1)         # the flip undone
    return ys_f, ys_b, ((ys_f[:, -1], c_fin[0]), (ys_b[:, 0], c_fin[1]))


def _rnn(x: torch.Tensor, weights: Sequence[torch.Tensor], mode: str,
         num_layers: int, training: bool
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``torch.nn.LSTM``'s or ``torch.nn.GRU``'s own call (batch_first,
    unidirectional, biased, from zero states) on the flat weights in
    torch's order: ``(ys, h_n, c_n)``, c_n zeros for the GRU."""
    h0 = x.new_zeros((num_layers, x.shape[0], weights[1].shape[1]))
    with warnings.catch_warnings():
        # A seed's weights are slices of the stacked ones, so cuDNN copies
        # them into one buffer each call, and says so.
        warnings.filterwarnings("ignore", message="RNN module weights are "
                                "not part of single contiguous chunk")
        if mode == "LSTM":
            return torch._VF.lstm(x, (h0, h0), weights, True, num_layers, 0.0,
                                  training, False, True)
        ys, h = torch._VF.gru(x, h0, weights, True, num_layers, 0.0,
                              training, False, True)
    return ys, h, torch.zeros_like(h)


class LibraryRnn:
    """The wrapper around ``gnn_rul_tpu_torch::library_rnn``, the library's
    RNN call as a registered operator for the layers under vmap. ``calls``
    counts its calls, one per seed: it launches no kernel of the port."""

    def __init__(self) -> None:
        self.calls = 0

    def __call__(self, x: torch.Tensor, weights: Sequence[torch.Tensor],
                 mode: str, num_layers: int, training: bool):
        return _rnn_op(x, list(weights), mode, num_layers, training)


library_rnn = LibraryRnn()


@torch.library.custom_op("gnn_rul_tpu_torch::library_rnn", mutates_args=())
def _rnn_op(x: torch.Tensor, weights: List[torch.Tensor], mode: str,
            num_layers: int, training: bool
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    library_rnn.calls += 1
    return _rnn(x, weights, mode, num_layers, training)


@_rnn_op.register_fake
def _rnn_fake(x, weights, mode, num_layers, training):
    hid = weights[1].shape[1]
    h = x.new_empty((num_layers, x.shape[0], hid))
    return x.new_empty((*x.shape[:2], hid)), h, torch.empty_like(h)


@_rnn_op.register_vmap
def _rnn_vmap(info, in_dims, x, weights, mode, num_layers, training):
    x_dim, w_dims = in_dims[0], in_dims[1]
    outs = [_rnn_op(x if x_dim is None else x.select(x_dim, i),
                    [w if d is None else w.select(d, i)
                     for w, d in zip(weights, w_dims)],
                    mode, num_layers, training)
            for i in range(info.batch_size)]
    return tuple(torch.stack(t) for t in zip(*outs)), (0, 0, 0)


def _rnn_setup(ctx, inputs, output) -> None:
    x, weights, ctx.mode, ctx.num_layers, _ = inputs
    ctx.save_for_backward(x, *weights)


def _rnn_backward(ctx, d_ys, d_h, d_c):
    x, *weights = ctx.saved_tensors
    with torch.enable_grad():
        inputs = [t.detach().requires_grad_() for t in (x, *weights)]
        ys, h, c = _rnn(inputs[0], inputs[1:], ctx.mode, ctx.num_layers,
                        True)
        outs, grads = [ys, h], [d_ys, d_h]
        if ctx.mode == "LSTM":
            outs.append(c)
            grads.append(d_c)
        dx, *dw = torch.autograd.grad(outs, inputs, grads)
    return dx, dw, None, None, None


_rnn_op.register_autograd(_rnn_backward, setup_context=_rnn_setup)


def _vmapped(module: nn.RNNBase, x: torch.Tensor) -> List[torch.Tensor]:
    """The module's flat weights by name (``torch.func.functional_call``
    sets them by name, not in ``_flat_weights``) where it runs under
    ``torch.func.vmap``, else an empty list."""
    weights = [getattr(module, n) for n in module._flat_weights_names]
    # torch.func has no public test for a tensor batched by vmap.
    if any(torch._C._functorch.is_batchedtensor(t) for t in (x, *weights)):
        return weights
    return []


class LSTMLayer(nn.LSTM):
    """Single-direction, single-layer LSTM over ``x (B, T, D)``: returns
    ``ys (B, T, H)`` and ``(h_n, c_n)``, each ``(B, H)``, from zero initial
    states, the contract of the JAX ``LSTMLayer``. It is
    ``torch.nn.LSTM(batch_first=True)`` under its own parameter names
    (``weight_ih_l0`` ...), the reference's keys."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__(input_size, hidden_size, batch_first=True)

    def forward(self, x: torch.Tensor):
        weights = _vmapped(self, x)
        if weights:
            ys, h, c = library_rnn(x, weights, "LSTM", 1, self.training)
        else:
            ys, (h, c) = super().forward(x)
        return ys, (h[0], c[0])


class LSTM(nn.LSTM):
    """``torch.nn.LSTM(batch_first=True)``, multi-layer and optionally
    bidirectional (each layer's two directions concatenated on the feature
    axis), under its own parameter names (``weight_ih_l{k}`` ...,
    ``_reverse`` for the backward direction). Returns ``ys`` and ``(h_n,
    c_n)``, each ``(layers * directions, B, H)`` in torch's order, from zero
    initial states: the contract of the JAX ``LSTM``. A bidirectional layer
    runs through :func:`bilstm_fused`, so through the recurrence kernels on
    the card; a unidirectional one through ``torch.nn.LSTM``."""

    def __init__(self, input_size: int, hidden_size: int, num_layers: int = 1,
                 bidirectional: bool = False):
        super().__init__(input_size, hidden_size, num_layers=num_layers,
                         batch_first=True, bidirectional=bidirectional)

    def _direction(self, layer: int, reverse: bool) -> Params:
        sfx = f"_l{layer}" + ("_reverse" if reverse else "")
        return (getattr(self, "weight_ih" + sfx).t(),
                getattr(self, "weight_hh" + sfx).t(),
                getattr(self, "bias_ih" + sfx),
                getattr(self, "bias_hh" + sfx))

    def forward(self, x: torch.Tensor):
        if not self.bidirectional:
            weights = _vmapped(self, x)
            if weights:
                ys, h, c = library_rnn(x, weights, "LSTM", self.num_layers,
                                       self.training)
                return ys, (h, c)
            return super().forward(x)
        h_last, c_last = [], []
        for layer in range(self.num_layers):
            fwd, bwd, ((hf, cf), (hb, cb)) = bilstm_fused(
                x, self._direction(layer, False), self._direction(layer, True))
            x = torch.cat([fwd, bwd], dim=-1)
            h_last += [hf, hb]
            c_last += [cf, cb]
        return x, (torch.stack(h_last), torch.stack(c_last))


class GRULayer(nn.GRU):
    """Single-direction, single-layer GRU over ``x (B, T, D)``: returns
    ``ys (B, T, H)`` and ``h_n (B, H)`` from a zero initial state, the
    contract of the JAX ``GRULayer``. It is ``torch.nn.GRU(batch_first=
    True)`` under its own parameter names (``weight_ih_l0 (3H, D)`` ...),
    the reference's keys; torch's gates [r, z, n] with ``b_hn`` inside
    ``r * (...)`` are the JAX step's."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__(input_size, hidden_size, batch_first=True)

    def forward(self, x: torch.Tensor):
        weights = _vmapped(self, x)
        if weights:
            ys, h, _ = library_rnn(x, weights, "GRU", 1, self.training)
        else:
            ys, h = super().forward(x)
        return ys, h[0]


class GRU(nn.GRU):
    """``torch.nn.GRU(batch_first=True)``, multi-layer: returns ``ys`` and
    ``h_n (layers, B, H)`` from a zero initial state, the contract of the
    JAX ``GRU``."""

    def __init__(self, input_size: int, hidden_size: int,
                 num_layers: int = 1):
        super().__init__(input_size, hidden_size, num_layers=num_layers,
                         batch_first=True)

    def forward(self, x: torch.Tensor):
        weights = _vmapped(self, x)
        if weights:
            ys, h, _ = library_rnn(x, weights, "GRU", self.num_layers,
                                   self.training)
            return ys, h
        return super().forward(x)
