"""serve.copy_share (%, entry layer): the share of the requests' wall time
in which the card copied a request's windows in or its answers out (the
profiler's memcpy activities under ``ServingModel``'s ``as_tensor`` and
``.cpu()``), over the harness's request spans."""

from portbench.harness.reading import total_ns, share


def read(r):
    if r.trace is None:
        return None
    requests = r.trace.spans("portbench.request")
    return share(total_ns(r.trace.memcpy), total_ns(requests))
