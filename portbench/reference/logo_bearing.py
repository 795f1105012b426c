"""LOGO_bearing (the GNN_RUL_Benchmarking suite's models/LOGO_bearing/
Model.py) in plain PyTorch, eval mode: each patch's STFT magnitude
(a Hann window, reflect-padded frames, a DFT as a matrix product); a
global Pearson graph over each bin's frames of all patches; LOGO's trunk:
a dot-product graph of the mapped nodes, the gated fusion of the two
graphs, a one-hop MPNN, a 3-layer direction-summed Bi-LSTM run along the
request's rows, and an MLP.

The Bi-LSTM's input is the reference's ``(num_patch * num_nodes, rows,
features)`` batch_first tensor: the recurrence runs along the request's
rows, so a window's answer depends on its request. Requests run side by
side as columns of one recurrence, each over its own length.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .lstm import bilstm_sum


def _linear(n_out: int, n_in: int, name: str):
    bound = n_in ** -0.5
    return [(f"{name}.weight", (n_out, n_in), bound),
            (f"{name}.bias", (n_out,), bound)]


def _lstm(name: str, d: int, h: int):
    out = []
    for sfx in ("", "_reverse"):
        out += [(f"{name}.weight_ih_l0{sfx}", (4 * h, d), h ** -0.5),
                (f"{name}.weight_hh_l0{sfx}", (4 * h, h), h ** -0.5),
                (f"{name}.bias_ih_l0{sfx}", (4 * h,), h ** -0.5),
                (f"{name}.bias_hh_l0{sfx}", (4 * h,), h ** -0.5)]
    return out


def param_specs(cfg: dict) -> List[Tuple[str, tuple, float]]:
    """``(name, shape, bound)`` of every parameter, under the original
    model's ``state_dict`` keys; each drawn uniform in ``±bound`` (torch's
    default initialisation)."""
    hp = cfg["model"]
    d, n, hid = hp["input_dim"], hp["num_nodes"], 3 * hp["hidden_dim"]
    specs = _linear(2 * d, d, "nonlin_map")
    for gate in ("W_Z_T", "W_Z_G", "W_R_T", "W_R_G", "W_h_T", "W_h"):
        specs += _linear(n, n, f"graph_attn_blk.{gate}")
    specs += _linear(3 * d, 2 * d, "MPNN.theta.0")
    specs += _lstm("TD.bi_lstm1", 3 * d, hid) \
        + _lstm("TD.bi_lstm2", hid, 2 * hid) + _lstm("TD.bi_lstm3", 2 * hid, hid)
    specs += _linear(16, n * hp["num_patch"] * hid, "fc.fc1") \
        + _linear(8, 16, "fc.fc2") + _linear(1, 8, "cls")
    return specs


def _lin(p: Dict[str, torch.Tensor], name: str, x: torch.Tensor):
    return torch.matmul(x, p[f"{name}.weight"].t()) + p[f"{name}.bias"]


def stft_magnitude(x: torch.Tensor, nperseg: int) -> torch.Tensor:
    """``(B, L)`` -> ``(B, nperseg // 2 + 1, 1 + L // nperseg)``: frames
    of ``nperseg`` at hop ``nperseg`` of the signal reflect-padded by
    ``nperseg // 2`` on each side, times the periodic Hann window, their
    one-sided DFT's magnitude."""
    half = nperseg // 2
    padded = F.pad(x[:, None, :], (half, half), mode="reflect")[:, 0]
    frames = padded.unfold(-1, nperseg, nperseg)          # (B, F, nperseg)
    k = torch.arange(nperseg, dtype=torch.float64, device=x.device)
    window = (0.5 - 0.5 * torch.cos(2 * math.pi * k / nperseg)).to(x.dtype)
    angle = 2 * math.pi * k[:, None] * torch.arange(
        half + 1, dtype=torch.float64, device=x.device)[None, :] / nperseg
    wf = frames * window
    re = torch.matmul(wf, torch.cos(angle).to(x.dtype))
    im = torch.matmul(wf, -torch.sin(angle).to(x.dtype))
    return torch.sqrt(re * re + im * im).transpose(1, 2)


def pearson(x: torch.Tensor) -> torch.Tensor:
    """Pearson correlation of the rows of ``(..., N, L)``, 1e-8 added to
    the denominator."""
    xc = x - x.mean(dim=-1, keepdim=True)
    cov = torch.matmul(xc, xc.transpose(-1, -2))
    sd = torch.sqrt(torch.sum(xc * xc, dim=-1))
    return cov / (sd[..., :, None] * sd[..., None, :] + 1e-8)


def _with_self(a: torch.Tensor) -> torch.Tensor:
    """``softmax(a - 1e8 I) + I`` over each row."""
    eye = torch.eye(a.shape[-1], dtype=a.dtype, device=a.device)
    return torch.softmax(a - 1e8 * eye, dim=-1) + eye


def forward(p: Dict[str, torch.Tensor], cfg: dict,
            requests: List[torch.Tensor]):
    """Each request ``(n, 1, length)`` -> its ``(n,)`` answers, in the
    parameters' dtype."""
    hp = cfg["model"]
    t, patch, seg = hp["num_patch"], hp["patch_size"], hp["nperseg"]
    dt = p["cls.weight"].dtype
    dev = p["cls.weight"].device
    sizes = [r.shape[0] for r in requests]
    x = torch.cat([r.to(dt) for r in requests])
    w = x.shape[0]
    mag = stft_magnitude(x.reshape(w * t, patch), seg)
    n, f = mag.shape[-2:]
    xp = mag.reshape(w, t, n, f)
    global_corr = pearson(xp.transpose(1, 2).reshape(w, n, t * f))
    nodes = xp.reshape(w * t, n, f)
    mapped = _lin(p, "nonlin_map", nodes)
    local = _with_self(F.leaky_relu(
        torch.matmul(mapped, mapped.transpose(1, 2)), 0.01))
    g = global_corr[:, None].expand(w, t, n, n).reshape(w * t, n, n)
    gate = "graph_attn_blk"
    z = torch.sigmoid(_lin(p, f"{gate}.W_Z_T", local)
                      + _lin(p, f"{gate}.W_Z_G", g))
    r = torch.sigmoid(_lin(p, f"{gate}.W_R_T", local)
                      + _lin(p, f"{gate}.W_R_G", g))
    a_hat = torch.tanh(_lin(p, f"{gate}.W_h_T", g) + _lin(p, f"{gate}.W_h", r))
    fused = _with_self((1.0 - z) * local + z * a_hat)
    mp = F.leaky_relu(_lin(p, "MPNN.theta.0", torch.matmul(fused, mapped)),
                      0.01)
    cols = t * n
    rows = mp.reshape(w, cols, -1)                        # (W, t*n, 3d)
    t_max = max(sizes)
    seq = torch.zeros((t_max, cols * len(sizes), rows.shape[-1]), dtype=dt,
                      device=dev)
    lengths = []
    for j, part in enumerate(rows.split(sizes)):
        seq[:sizes[j], cols * j:cols * (j + 1)] = part
        lengths += [sizes[j]] * cols
    h = seq
    for layer in (1, 2, 3):
        h = bilstm_sum(h, p, f"TD.bi_lstm{layer}",
                       torch.tensor(lengths, device=dev))
    h = F.leaky_relu(h, 0.01)
    td = torch.cat([h[:sizes[j], cols * j:cols * (j + 1)]
                    for j in range(len(sizes))])          # (W, t*n, H)
    head = torch.relu(_lin(p, "fc.fc2", torch.relu(
        _lin(p, "fc.fc1", td.reshape(w, -1)))))
    out = _lin(p, "cls", head)[:, 0]
    return list(out.split(sizes))
