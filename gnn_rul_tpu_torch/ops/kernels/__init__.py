"""Hand-written CUDA kernels and their plain PyTorch versions.

``WRAPPERS`` maps each registered operator
(``torch.ops.gnn_rul_tpu_torch.<name>``) to the wrapper that launches its
kernel and counts the launches."""

from . import fused_gat, fused_gnn, fused_lstm

WRAPPERS = {
    "fused_dot_graph_spmm": fused_gnn.fused_dot_graph_spmm,
    "lstm_recurrence": fused_lstm.lstm_recurrence,
    "fused_gat": fused_gat.fused_gat,
}
