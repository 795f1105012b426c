"""idle_share.forward (%, models layer): the card's idle time inside the
program's forward spans (``serve.forward``: the model's ops issued by the
host), as a share of the traced window: the card starved while the host
issues the model's ops. None where the program records no such spans."""


def read(r):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    forwards = r.trace.spans("serve.forward")   # disjoint, sorted by start
    if not forwards:
        return None
    busy = r.trace.busy_intervals()              # disjoint, sorted
    idle, j = 0, 0
    for f in forwards:
        while j < len(busy) and busy[j][1] <= f.start:
            j += 1
        covered, k = 0, j
        while k < len(busy) and busy[k][0] < f.end:
            covered += min(busy[k][1], f.end) - max(busy[k][0], f.start)
            k += 1
        idle += f.dur - covered
    return 100.0 * idle * 1e-9 / r.trace.window_s
