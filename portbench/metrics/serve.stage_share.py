"""serve.stage_share (%, entry layer): the share of the program's request
spans (``serve.call``, ``gnn_rul_tpu_torch/export.py::ServingModel``) in
which it staged the request's windows onto the card (``serve.stage_in``:
``torch.as_tensor`` to the device, the host's copy and the H->D copy).
None where the program records no such spans."""

from portbench.harness.reading import total_ns, share


def read(r):
    if r.trace is None:
        return None
    return share(total_ns(r.trace.spans("serve.stage_in")),
                 total_ns(r.trace.spans("serve.call")))
