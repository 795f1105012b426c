"""mfu.serve (%, the whole request): the model's forward operations over
the windows answered in the traced window (the configuration's
``counts``), over the window's length, as a share of the fp32 peak."""

from portbench.counts import peaks


def read(r):
    if r.trace is None or not r.calls.get("request"):
        return None
    flops = sum(r.counts.forward_flops(r.config, n)
                for n in r.calls["request"])
    return 100.0 * flops / r.trace.window_s / peaks.FP32_FLOP_PER_S
