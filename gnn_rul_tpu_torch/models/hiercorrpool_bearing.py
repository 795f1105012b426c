"""HierCorrPool_bearing: HierCorrPool behind an STFT front end (counterpart
of ``gnn_rul_tpu/models/hiercorrpool_bearing.py``).

Reference HierCorrPool_bearing_model (models/HierCorrPool_bearing/
Model.py:6-67). Each of the ``num_patch`` patches of the signal becomes
its STFT magnitude, ``nperseg // 2 + 1`` frequency bins (the nodes) by
``1 + patch_size // nperseg`` frames (each node's features); the trunk
after that is HierCorrPool's, whose Model_Base the reference shares byte
for byte, under the same flat keys (``gnn_rul_tpu/compat/torch_import.py::
_hiercorrpool_core``). No kernel of the port runs in this model; the STFT
is ``torch.stft`` (cuFFT on the card).
"""

from __future__ import annotations

import torch

from ..signal.stft import stft_magnitude
from .hiercorrpool import HierCorrPool


class HierCorrPoolBearing(HierCorrPool):
    """Input ``(B, 1, num_patch * patch_size)`` -> ``(B, 1)``. Takes the
    hparam bank's keyword arguments; ``num_nodes`` must be the STFT's bin
    count, ``nperseg // 2 + 1``."""

    def __init__(self, patch_size: int, num_patch: int, input_dim: int,
                 hidden_dim: int, embedding_dim: int, num_nodes: int,
                 nperseg: int, encoder_conv_kernel: int, num_nodes_out: int,
                 spmm_fn=None):
        bins, frames = nperseg // 2 + 1, 1 + patch_size // nperseg
        if num_nodes != bins:
            raise ValueError(f"HierCorrPool_bearing: num_nodes={num_nodes}, "
                             f"but nperseg={nperseg} gives {bins} bins")
        # The trunk sees each bin as a node of `frames` features.
        super().__init__(frames, num_patch, input_dim, hidden_dim,
                         embedding_dim, bins, encoder_conv_kernel,
                         num_nodes_out, spmm_fn=spmm_fn)
        self.signal_patch, self.nperseg = patch_size, nperseg

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        flat = x.reshape(b * self.num_patch, self.signal_patch)
        mag = stft_magnitude(flat, self.nperseg)   # (B*T, bins, frames)
        return self.trunk(mag.reshape(b, self.num_patch, *mag.shape[-2:]))
