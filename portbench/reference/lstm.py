"""A plain bidirectional LSTM layer, the two directions summed, over
columns of different lengths: the reference's recurrence.

Gates in torch's order [i, f, g, o], zero initial states, weights under
``torch.nn.LSTM``'s names (``weight_ih_l0 (4H, D)``, ``weight_hh_l0 (4H,
H)``, ``bias_ih_l0``, ``bias_hh_l0`` and the ``_reverse`` twins). One step
at a time, both directions in one batched product a step.
"""

from __future__ import annotations

from typing import Dict

import torch


def _reversal(lengths: torch.Tensor, t_max: int) -> torch.Tensor:
    """``(t_max, B)`` time indices that reverse each column's first
    ``lengths[b]`` steps and leave its padding in place; applying it twice
    is the identity."""
    s = torch.arange(t_max, device=lengths.device)[:, None]
    return torch.where(s < lengths[None, :], lengths[None, :] - 1 - s, s)


def bilstm_sum(x: torch.Tensor, params: Dict[str, torch.Tensor],
               prefix: str, lengths: torch.Tensor) -> torch.Tensor:
    """``x (T, B, D)``, time-major, column ``b`` valid for its first
    ``lengths[b]`` steps -> the forward and backward outputs summed, ``(T,
    B, H)``; the padding steps' outputs are meaningless."""
    t_max, b, _ = x.shape

    def proj(sfx: str) -> torch.Tensor:
        w = params[f"{prefix}.weight_ih_l0{sfx}"]
        bias = (params[f"{prefix}.bias_ih_l0{sfx}"]
                + params[f"{prefix}.bias_hh_l0{sfx}"])
        return torch.matmul(x, w.t()) + bias

    rev = _reversal(lengths, t_max)
    idx = rev[:, :, None]
    xf = proj("")
    xb = torch.gather(proj("_reverse"), 0, idx.expand(-1, -1, xf.shape[-1]))
    xg = torch.stack([xf, xb], dim=1)                       # (T, 2, B, 4H)
    w_hh = torch.stack([params[f"{prefix}.weight_hh_l0"].t(),
                        params[f"{prefix}.weight_hh_l0_reverse"].t()])
    hid = w_hh.shape[1]
    h = x.new_zeros((2, b, hid))
    c = x.new_zeros((2, b, hid))
    ys = x.new_empty((t_max, 2, b, hid))
    for s in range(t_max):
        g = torch.baddbmm(xg[s], h, w_hh)
        act = torch.sigmoid(g)
        c = act[..., hid:2 * hid] * c \
            + act[..., :hid] * torch.tanh(g[..., 2 * hid:3 * hid])
        h = act[..., 3 * hid:] * torch.tanh(c)
        ys[s] = h
    back = torch.gather(ys[:, 1], 0, idx.expand(-1, -1, hid))
    return ys[:, 0] + back
