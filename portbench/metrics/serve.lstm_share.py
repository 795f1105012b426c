"""serve.lstm_share (%, models layer): the share of the card's busy time in
the window spent in the Bi-LSTM forward kernel (#4)."""

from portbench.harness.reading import LSTM_FWD_KERNELS, total_ns, share


def read(r):
    if r.trace is None:
        return None
    return share(total_ns(r.trace.kernels(*LSTM_FWD_KERNELS)) * 1e-9,
                 r.trace.busy_s())
