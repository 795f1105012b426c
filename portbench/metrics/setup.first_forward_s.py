"""setup.first_forward_s (s, models layer): the forward of the first
request of set-up as the program timed it, the seconds of the process's
first ``serve.forward`` (``gnn_rul_tpu_torch.telemetry.cold_start``): where
the kernels' loads and every other first-call set-up land. None where the
program keeps no such table."""


def read(r):
    try:
        from gnn_rul_tpu_torch import telemetry
    except ImportError:
        return None
    return telemetry.cold_start()["first_s"].get("serve.forward")
