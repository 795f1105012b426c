"""Operations and bytes of the dot-graph forward kernel (#2,
``csrc/fused_gnn.cu``), per call of the registered operator
``gnn_rul_tpu_torch::fused_dot_graph_spmm`` on ``h (B, N, D)``, ``x (B,
N, F)`` and one ``(N, N)`` mask, as ``chip_smoke.py::_bound_ms`` counts
them: h, x and the mask read once and the output written once; ``2 B N^2
(D + F)`` operations, the scores ``h h^T`` and the aggregation.
"""

from __future__ import annotations

from typing import Tuple

# The kernel's two plans, matched by name fragment in the device trace;
# neither fragment is in the backward's ``bwd_*`` kernels, the graph
# attention's ``fused_gat_kernel`` or the LSTM's kernels.
FWD_KERNELS = ("fwd_graph_kernel", "fwd_rows_kernel")


def forward(b: int, n: int, d: int, f: int) -> Tuple[float, float]:
    """``(flops, bytes)`` of one float32 forward call."""
    nbytes = 4 * (b * n * d + 2 * b * n * f + n * n)
    flops = 2 * b * n * n * (d + f)
    return float(flops), float(nbytes)
