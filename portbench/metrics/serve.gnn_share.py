"""serve.gnn_share (%, models layer): the share of the card's busy time in
the window spent in the dot-graph forward kernel (#2)."""

from portbench.counts.gnn import FWD_KERNELS
from portbench.harness.reading import share, total_ns


def read(r):
    if r.trace is None:
        return None
    return share(total_ns(r.trace.kernels(*FWD_KERNELS)) * 1e-9,
                 r.trace.busy_s())
