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
"""

from __future__ import annotations

import math
from typing import Tuple

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


class LSTMLayer(nn.LSTM):
    """Single-direction, single-layer LSTM over ``x (B, T, D)``: returns
    ``ys (B, T, H)`` and ``(h_n, c_n)``, each ``(B, H)``, from zero initial
    states, the contract of the JAX ``LSTMLayer``. It is
    ``torch.nn.LSTM(batch_first=True)`` under its own parameter names
    (``weight_ih_l0`` ...), the reference's keys."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__(input_size, hidden_size, batch_first=True)

    def forward(self, x: torch.Tensor):
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
