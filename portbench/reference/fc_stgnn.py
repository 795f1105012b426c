"""FC_STGNN (Wang et al., the GNN_RUL_Benchmarking suite's models/FC_STGNN/
Model.py and Model_Base.py:175-225) in plain PyTorch, eval mode: each
sensor's patch through a two-block 1D-CNN, a Linear and its BatchNorm; a
sinusoidal encoding over the patches (base 100); two space-time MPNN
blocks, each over sliding windows of patches: the dot graph
``softmax(leaky(h h^T - 1e8 I, 0.01)) + I`` of the mapped nodes times the
decay mask, its product with the BatchNormed nodes, theta, BatchNorm,
leaky ReLU and the mean over the window's time; the blocks' outputs
concatenated into a four-layer MLP.

The window sizes, strides and decay are the model's defaults, which the
hparam bank does not set. Each request runs alone, and every window of it
on its own (BatchNorm in eval mode mixes no windows), so a request's
answers do not depend on the others. Dropout is off, as in eval mode.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn.functional as F

MOVING_WINDOW = (2, 2)   # patches a window, block 1 and block 2
STRIDE = (1, 2)          # patches between windows
DECAY = 0.7              # the mask's weight a patch apart
PE_BASE = 100.0
SLOPE = 0.01             # leaky ReLU's negative slope
BN_EPS = 1e-5
BN_BOUND = 0.1           # BatchNorm's weight, bias and mean: 1, 0, 0 ± this
BN_VAR = (1.0, 0.5)      # running variance: centre, bound


def _linear(name: str, shape_out: int, shape_in: int):
    bound = shape_in ** -0.5
    return [(f"{name}.weight", (shape_out, shape_in), bound),
            (f"{name}.bias", (shape_out,), bound)]


def _bn(name: str, c: int):
    """A BatchNorm's state as a trained model holds it: every entry of its
    ``state_dict`` named, the running variance kept positive."""
    return [(f"{name}.weight", (c,), BN_BOUND, 1.0),
            (f"{name}.bias", (c,), BN_BOUND),
            (f"{name}.running_mean", (c,), BN_BOUND),
            (f"{name}.running_var", (c,), BN_VAR[1], BN_VAR[0]),
            (f"{name}.num_batches_tracked", (), 0.0)]


def windows_of(num_patch: int) -> List[int]:
    """The windows of each MPNN block over ``num_patch`` patches."""
    return [(num_patch - w) // s + 1 for w, s in zip(MOVING_WINDOW, STRIDE)]


def param_specs(cfg: dict) -> List[tuple]:
    """``(name, shape, bound[, centre])`` of every entry of the original
    model's ``state_dict``, drawn uniform in ``centre ± bound`` (centre 0
    where not given): convolutions and Linears as torch initialises them
    (±1/sqrt(fan-in)), BatchNorms by :func:`_bn`."""
    hp = cfg["model"]
    k, eh, eo = (hp["encoder_conv_kernel"], hp["encoder_hidden_dim"],
                 hp["encoder_out_dim"])
    hid, n = hp["hidden_dim"], hp["num_node"]
    feat = 2 * hid
    specs = [("nonlin_map.conv_block1.0.weight", (eh, 1, k), k ** -0.5)]
    specs += _bn("nonlin_map.conv_block1.1", eh)
    specs += [("nonlin_map.conv_block2.0.weight", (eo, eh, k),
               (eh * k) ** -0.5)]
    specs += _bn("nonlin_map.conv_block2.1", eo)
    specs += _linear("nonlin_map2.0", feat, eo * hp["encoder_time_out"])
    specs += _bn("nonlin_map2.1", feat)
    for b in ("MPNN1", "MPNN2"):
        specs += _linear(f"{b}.graph_construction.mapping", feat, feat)
        specs += _bn(f"{b}.BN", feat)
        specs += _linear(f"{b}.MPNN.theta.0", hid, feat)
        specs += _bn(f"{b}.MPNN.bn1", hid)
    flat = sum(windows_of(hp["num_patch"])) * n * hid
    specs += _linear("fc.fc1", 2 * hid, flat) \
        + _linear("fc.fc2", 2 * hid, 2 * hid) \
        + _linear("fc.fc3", hid, 2 * hid) + _linear("fc.fc4", 1, hid)
    return specs


def _lin(p: Dict[str, torch.Tensor], name: str, x: torch.Tensor):
    return torch.matmul(x, p[f"{name}.weight"].t()) + p[f"{name}.bias"]


def _norm(p, name: str, x: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Eval BatchNorm over ``x``'s channel ``axis``."""
    shape = [1] * x.dim()
    shape[axis] = x.shape[axis]

    def v(key):
        return p[f"{name}.{key}"].reshape(shape)
    return (x - v("running_mean")) / torch.sqrt(v("running_var") + BN_EPS) \
        * v("weight") + v("bias")


def _encoding(length: int, width: int, dt, dev) -> torch.Tensor:
    pos = torch.arange(length, dtype=torch.float64, device=dev)[:, None]
    div = torch.exp(torch.arange(0, width, 2, dtype=torch.float64, device=dev)
                    * -(math.log(PE_BASE) / width))
    pe = torch.zeros((length, width), dtype=torch.float64, device=dev)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div[:pe[:, 1::2].shape[1]])
    return pe.to(dt)


def _mask(n: int, window: int, dt, dev) -> torch.Tensor:
    """``M[(ti, i), (tj, j)] = DECAY ** |ti - tj|``, nodes time-major."""
    t = torch.arange(window * n, device=dev) // n
    return (DECAY ** (t[:, None] - t[None, :]).abs().to(torch.float64)).to(dt)


def _block(p, name: str, enc: torch.Tensor, window: int, stride: int):
    """One space-time MPNN block: ``(W, T, N, F)`` -> ``(W, windows, N,
    hidden)``."""
    w_count, t, n, f = enc.shape
    starts = range(0, t - window + 1, stride)
    nodes = torch.stack([enc[:, s:s + window] for s in starts], dim=1)
    nw = nodes.shape[1]
    nodes = nodes.reshape(w_count * nw, window * n, f)
    h = _lin(p, f"{name}.graph_construction.mapping", nodes)
    eye = torch.eye(window * n, dtype=enc.dtype, device=enc.device)
    sim = F.leaky_relu(torch.matmul(h, h.transpose(1, 2)) - 1e8 * eye, SLOPE)
    adj = (torch.softmax(sim, dim=-1) + eye) \
        * _mask(n, window, enc.dtype, enc.device)
    agg = torch.matmul(adj, _norm(p, f"{name}.BN", nodes))
    out = _norm(p, f"{name}.MPNN.bn1", _lin(p, f"{name}.MPNN.theta.0", agg))
    out = F.leaky_relu(out, SLOPE)
    return out.reshape(w_count, nw, window, n, -1).mean(dim=2)


def _one(p, hp: dict, x: torch.Tensor) -> torch.Tensor:
    """One request ``(W, N, L)`` -> its ``(W,)`` answers."""
    w_count, n, _ = x.shape
    t, patch = hp["num_patch"], hp["patch_size"]
    k = hp["encoder_conv_kernel"]
    seq = x.reshape(w_count, n, t, patch).transpose(1, 2) \
        .reshape(w_count * t * n, 1, patch)
    y = F.conv1d(seq, p["nonlin_map.conv_block1.0.weight"], padding=k // 2)
    y = torch.relu(_norm(p, "nonlin_map.conv_block1.1", y, axis=1))
    y = F.conv1d(y, p["nonlin_map.conv_block2.0.weight"], padding=1)
    y = torch.relu(_norm(p, "nonlin_map.conv_block2.1", y, axis=1))
    enc = _norm(p, "nonlin_map2.1",
                _lin(p, "nonlin_map2.0", y.reshape(w_count * t * n, -1)))
    enc = enc.reshape(w_count, t, n, -1)
    enc = enc + _encoding(t, enc.shape[-1], enc.dtype, enc.device)[:, None]
    feats = torch.cat([
        _block(p, f"MPNN{i + 1}", enc, MOVING_WINDOW[i], STRIDE[i])
        .reshape(w_count, -1) for i in range(2)], dim=-1)
    for fc in ("fc.fc1", "fc.fc2", "fc.fc3"):
        feats = torch.relu(_lin(p, fc, feats))
    return _lin(p, "fc.fc4", feats)[:, 0]


def forward(p: Dict[str, torch.Tensor], cfg: dict,
            requests: List[torch.Tensor]):
    """Each request ``(n, sensors, length)`` -> its ``(n,)`` answers, in the
    parameters' dtype, each request alone."""
    dt = p["fc.fc1.weight"].dtype
    return [_one(p, cfg["model"], r.to(dt)) for r in requests]
