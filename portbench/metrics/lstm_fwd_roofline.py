"""lstm_fwd_roofline (%, kernels layer): kernel #4's least time over the
window's calls (each call's operations at the fp32 peak or its bytes at
the HBM rate, the larger; ``counts/lstm.py``) over its device time. The
calls are those of each request's forward, from the configuration's
``counts``."""

from portbench.counts import lstm, peaks
from portbench.harness.reading import LSTM_FWD_KERNELS, total_ns, share


def read(r):
    if r.trace is None:
        return None
    least = sum(peaks.least_s(*lstm.forward(*call))
                for n in r.calls.get("request", [])
                for call in r.counts.lstm_calls(r.config, n))
    return share(least, total_ns(r.trace.kernels(*LSTM_FWD_KERNELS)) * 1e-9)
