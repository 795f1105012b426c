"""What the per-layer readers share: the kernels' names, device time, and
shares that are None, never 0, where there is nothing to read."""

from __future__ import annotations

from typing import Optional

LSTM_FWD_KERNELS = ("lstm_fwd_kernel",)   # kernel #4, csrc/fused_lstm.cu


def total_ns(spans) -> int:
    """The summed length of ``spans``, in nanoseconds."""
    return sum(s.dur for s in spans)


def share(part: float, whole: float) -> Optional[float]:
    """``100 * part / whole`` in %, or None where there is nothing to
    read."""
    if whole <= 0 or part <= 0:
        return None
    return 100.0 * part / whole
