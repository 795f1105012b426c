"""gnn_fwd_roofline (%, kernels layer): the dot-graph forward kernel's (#2)
least time over the window's calls (each call's operations at the fp32
peak or its bytes at the HBM rate, the larger; ``counts/gnn.py``) over its
device time. The calls are those of each request's forward, from the
configuration's ``counts``; None for a configuration that makes none."""

from portbench.counts import gnn, peaks
from portbench.harness.reading import share, total_ns


def read(r):
    calls = getattr(r.counts, "gnn_calls", None)
    if r.trace is None or calls is None:
        return None
    least = sum(peaks.least_s(*gnn.forward(*call))
                for n in r.calls.get("request", [])
                for call in calls(r.config, n))
    return share(least, total_ns(r.trace.kernels(*gnn.FWD_KERNELS)) * 1e-9)
