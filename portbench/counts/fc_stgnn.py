"""FC_STGNN's forward operations per request: every convolution, matrix
product and graph aggregation as 2 m n k (the elementwise work is left
out), from the configuration's widths and the reference's window sizes. A
request of ``n`` windows runs each window's ``num_patch x num_node``
patches through the encoder, then each MPNN block's space-time graphs of
``window x num_node`` nodes, then the head."""

from __future__ import annotations

from typing import List, Tuple

from portbench.reference.fc_stgnn import MOVING_WINDOW, windows_of


def forward_flops(cfg: dict, n: int) -> float:
    hp = cfg["model"]
    t, nodes, hid = hp["num_patch"], hp["num_node"], hp["hidden_dim"]
    k, eh, eo = (hp["encoder_conv_kernel"], hp["encoder_hidden_dim"],
                 hp["encoder_out_dim"])
    feat, patch, tout = 2 * hid, hp["patch_size"], hp["encoder_time_out"]
    l1 = patch + 2 * (k // 2) - k + 1               # conv_block1's length
    per_patch = (2 * l1 * eh * k                    # conv_block1
                 + 2 * tout * eo * eh * k           # conv_block2
                 + 2 * eo * tout * feat)            # nonlin_map2
    per_window = t * nodes * per_patch
    flat = 0
    for window, graphs in zip(MOVING_WINDOW, windows_of(t)):
        m = window * nodes
        per_window += graphs * (2 * m * feat * feat          # mapping
                                + 2 * m * m * (feat + feat)  # kernel #2
                                + 2 * m * feat * hid)        # theta
        flat += graphs * nodes * hid
    per_window += 2 * (flat * 2 * hid + 2 * hid * 2 * hid
                       + 2 * hid * hid + hid)                # the head
    return float(n * per_window)


def gnn_calls(cfg: dict, n: int) -> List[Tuple[int, int, int, int]]:
    """``(B, N, D, F)`` of each dot-graph call of a forward over ``n``
    windows: one a block, its graphs the windows' space-time windows."""
    hp = cfg["model"]
    feat = 2 * hp["hidden_dim"]
    blocks = zip(MOVING_WINDOW, windows_of(hp["num_patch"]))
    return [(graphs * n, window * hp["num_node"], feat, feat)
            for window, graphs in blocks]
