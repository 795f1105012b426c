"""Static windowing / patching utilities (counterpart of
``gnn_rul_tpu/ops/windows.py``)."""

from __future__ import annotations

import numpy as np
import torch


def patchify(x: torch.Tensor, num_patch: int, patch_size: int) -> torch.Tensor:
    """``(B, C, L) -> (B, num_patch, C, patch_size)``.

    Matches ``reshape(bs, C, num_patch, patch_size); transpose(1, 2)``
    (reference models/FC_STGNN/Model.py:46-47).
    """
    b, c, _ = x.shape
    return x.reshape(b, c, num_patch, patch_size).transpose(1, 2)


def sliding_time_windows(x: torch.Tensor, window: int,
                         stride: int) -> torch.Tensor:
    """``(B, T, N, D) -> (B, num_windows, window, N, D)``: window ``w`` is
    ``x[:, w*stride : w*stride+window]``, time-major, so each window flattens
    to ``window*N`` nodes in blocks of N per timestep (the layout the decay
    mask expects)."""
    num_windows = (x.shape[1] - window) // stride + 1
    return torch.stack([x[:, w * stride: w * stride + window]
                        for w in range(num_windows)], dim=1)


def decay_mask(num_node: int, time_window: int, decay: float,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Space-time decay mask ``M[(ti,ni),(tj,nj)] = decay^|ti-tj|`` of shape
    ``(time_window*num_node, time_window*num_node)``, built with numpy on the
    host (reference Mask_Matrix, models/FC_STGNN/Model_Base.py:150-170)."""
    ti = np.arange(time_window)
    block = decay ** np.abs(ti[:, None] - ti[None, :])
    mask = np.kron(block, np.ones((num_node, num_node)))
    return torch.as_tensor(mask, dtype=dtype)
