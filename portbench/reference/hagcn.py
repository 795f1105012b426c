"""HAGCN (Li et al., the GNN_RUL_Benchmarking suite's models/HAGCN/
Model.py) in plain PyTorch, eval mode: a 3-layer direction-summed Bi-LSTM
over each window's patches, run along the request's rows times its
sensors; a cosine graph; three GIN + SAGPool stages keeping 10, 5 and 1
nodes; the stages' node means; an MLP.

The Bi-LSTM's input is the reference's ``(num_patch, rows * sensors,
patch)`` batch_first tensor: the recurrence runs along the whole
request's rows, so a window's answer depends on its request. Requests run
side by side as columns of one recurrence, each over its own length.

SAGPool keeps the nodes of highest score, a step function; with random
weights a graph's scores lie within 1e-5 (relative) of each other on many
windows, so a float32 run keeps another node than this float64 one on a
few windows, and their answers part by up to a few percent
(``PERF.md`` §2).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .lstm import bilstm_sum

KEEP = (10, 5, 1)   # the nodes each SAGPool stage keeps


def _linear(shape_out: int, shape_in: int, name: str):
    bound = shape_in ** -0.5
    return [(f"{name}.weight", (shape_out, shape_in), bound),
            (f"{name}.bias", (shape_out,), bound)]


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
    model's ``state_dict`` keys; each is drawn uniform in ``±bound``
    (torch's default initialisation; GIN's eps in ±0.1)."""
    hp = cfg["model"]
    p, e, h, o = (hp["patch_size"], hp["encoder_hidden_dim"],
                  hp["hidden_dim"], hp["output_dim"])
    specs = _lstm("TD.bi_lstm1", p, e) + _lstm("TD.bi_lstm2", e, 2 * e) \
        + _lstm("TD.bi_lstm3", 2 * e, e)
    for i, d_in in ((1, e), (2, h), (3, h)):
        specs += [(f"gin{i}.eps", (1,), 0.1)]
        specs += _linear(h, d_in, f"gin{i}.mlp.0") \
            + _linear(h, h, f"gin{i}.mlp.2")
        specs += _linear(h, h, f"gnn{i}.model") + _linear(1, h, f"gnn{i}.rank") \
            + _linear(h // 2, h, f"gnn{i}.mlp.0") \
            + _linear(1, h // 2, f"gnn{i}.mlp.2")
    specs += _linear(o, hp["num_patch"] * 3 * h, "fc.0") + _linear(1, o, "fc.2")
    return specs


def _lin(p: Dict[str, torch.Tensor], name: str, x: torch.Tensor):
    return torch.matmul(x, p[f"{name}.weight"].t()) + p[f"{name}.bias"]


def _gin(p, name: str, x, adj):
    y = torch.matmul(adj, x) + (1.0 + p[f"{name}.eps"][0]) * x
    return _lin(p, f"{name}.mlp.2", torch.relu(_lin(p, f"{name}.mlp.0", y)))


def _stages(p, nodes, adj):
    """The three GIN + SAGPool stages of graphs ``(G, N, E)`` -> the
    stages' node means ``(G, 3 h)``. Each stage keeps its nodes of highest
    score, the lower index first among equal scores."""
    x, a, means = nodes, adj, []
    for s, keep in enumerate(KEEP):
        g = _gin(p, f"gin{s + 1}", x, a)
        ax = torch.matmul(a, g)
        x_out = F.leaky_relu(_lin(p, f"gnn{s + 1}.model", ax), 0.01)
        score = torch.softmax(_lin(p, f"gnn{s + 1}.rank", ax)[..., 0], dim=-1)
        top = torch.sort(score, dim=-1, descending=True,
                         stable=True).indices[:, :keep]
        x = torch.gather(x_out, 1, top[..., None].expand(-1, -1,
                                                         x_out.shape[-1]))
        rows = torch.gather(a, 1, top[..., None].expand(-1, -1, a.shape[-1]))
        a = torch.gather(rows, 2, top[:, None, :].expand(-1, keep, -1))
        means.append(x.mean(dim=1))
    return torch.cat(means, dim=-1)


def _head(p, feats: torch.Tensor) -> torch.Tensor:
    """``(W, t * 3 h)`` -> ``(W,)``."""
    return _lin(p, "fc.2", torch.relu(_lin(p, "fc.0", feats)))[:, 0]


def forward(p: Dict[str, torch.Tensor], cfg: dict,
            requests: List[torch.Tensor]):
    """Each request ``(n, sensors, length)`` -> its ``(n,)`` answers, in the
    parameters' dtype."""
    hp = cfg["model"]
    t, patch = hp["num_patch"], hp["patch_size"]
    dt = p["fc.0.weight"].dtype
    dev = p["fc.0.weight"].device
    sensors = requests[0].shape[1]
    lens = [r.shape[0] * sensors for r in requests]
    t_max = max(lens)
    x = torch.zeros((t_max, t * len(requests), patch), dtype=dt, device=dev)
    for j, r in enumerate(requests):
        x[:lens[j], t * j:t * (j + 1)] = r.to(dt).reshape(lens[j], t, patch)
    lengths = torch.tensor([n for n in lens for _ in range(t)], device=dev)
    h = x
    for layer in (1, 2, 3):
        h = bilstm_sum(h, p, f"TD.bi_lstm{layer}", lengths)
    h = F.leaky_relu(h, 0.01)
    nodes = torch.cat([
        h[:lens[j], t * j:t * (j + 1)].reshape(r.shape[0], sensors, t, -1)
        .transpose(1, 2).reshape(r.shape[0] * t, sensors, -1)
        for j, r in enumerate(requests)])                 # (W*t, sensors, E)
    norm = torch.clamp(torch.sqrt(torch.sum(nodes * nodes, -1)), min=1e-12)
    adj = torch.matmul(nodes, nodes.transpose(1, 2)) \
        / (norm[:, :, None] * norm[:, None, :])
    windows = sum(r.shape[0] for r in requests)
    out = _head(p, _stages(p, nodes, adj).reshape(windows, -1))
    sizes = [r.shape[0] for r in requests]
    return list(out.split(sizes))
