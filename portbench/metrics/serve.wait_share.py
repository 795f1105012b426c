"""serve.wait_share (%, the whole request): the share of the program's
request spans (``serve.call``) in which the host waited for the card's
answer and copied it back (``serve.fetch_out``: ``.cpu()``, which waits
for the forward's work still queued, then the D->H copy). None where the
program records no such spans."""

from portbench.harness.reading import total_ns, share


def read(r):
    if r.trace is None:
        return None
    return share(total_ns(r.trace.spans("serve.fetch_out")),
                 total_ns(r.trace.spans("serve.call")))
