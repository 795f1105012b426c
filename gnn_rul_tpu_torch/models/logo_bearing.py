"""LOGO_bearing: LOGO behind an STFT front end (counterpart of
``gnn_rul_tpu/models/logo_bearing.py``).

Reference LOGO_bearing_model (models/LOGO_bearing/Model.py:263-348). Each
of the ``num_patch`` patches of the signal becomes its STFT magnitude,
``nperseg // 2 + 1`` frequency bins (the nodes) by ``1 + patch_size //
nperseg`` frames (each node's features). The global Pearson graph is taken
over each bin's whole spectrogram, its frames of every patch in a row
(reference :307-309); then LOGO's trunk (:class:`LOGOCore`: fusion gate,
MPNN, the Bi-LSTM along the batch axis on the recurrence kernels, GL
loss), under LOGO's keys (``gnn_rul_tpu/compat/torch_import.py::
_map_logo_bearing`` is ``_logo_core``).

As in LOGO, the recurrence runs over the rows of a forward, so a row's
answer depends on the other rows, padding rows included: the engine's
evaluation pads the test set with its last row exactly as the JAX engine
does, and those rows reach the real rows' answers there as in JAX. The
training steps run the reference's per-batch ``MultiStepLR``
(``train/engine.py``).
"""

from __future__ import annotations

import torch

from ..ops.graphs import pearson_graph
from ..signal.stft import stft_magnitude
from ..telemetry import span
from .logo import LOGOCore


class LOGOBearing(LOGOCore):
    """Input ``(B, 1, num_patch * patch_size)`` -> ``(B, 1)``; ``(pred,
    gl_loss)`` in ``train()`` mode. Takes the hparam bank's keyword
    arguments; ``num_nodes`` and ``input_dim`` must be the STFT's bins and
    frames."""

    def __init__(self, patch_size: int, num_patch: int, input_dim: int,
                 num_nodes: int, nperseg: int, hidden_dim: int,
                 gamma: float = 1.0, spmm_fn=None):
        bins, frames = nperseg // 2 + 1, 1 + patch_size // nperseg
        if (num_nodes, input_dim) != (bins, frames):
            raise ValueError(
                f"LOGO_bearing: num_nodes={num_nodes}, input_dim={input_dim}"
                f", but nperseg={nperseg} at patch_size={patch_size} gives "
                f"{bins} bins of {frames} frames")
        super().__init__(frames, hidden_dim, bins, num_patch, gamma, spmm_fn)
        self.patch_size, self.num_patch, self.nperseg = (patch_size,
                                                         num_patch, nperseg)

    def forward(self, x: torch.Tensor):
        b, t = x.shape[0], self.num_patch
        with span("logo_bearing.front_end"):
            mag = stft_magnitude(x.reshape(b * t, self.patch_size),
                                 self.nperseg)
            n, f = mag.shape[-2:]
            xp = mag.reshape(b, t, n, f)
            # Each bin's frames over every patch: (B, N, T * f).
            global_corr = pearson_graph(
                xp.transpose(1, 2).reshape(b, n, t * f))
        return self.trunk(xp, global_corr)
