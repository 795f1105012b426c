"""setup.first_call_s (s, entry layer): the first request of set-up as the
program timed it, the seconds of the process's first ``serve.call``
(``gnn_rul_tpu_torch.telemetry.cold_start``). None where the program keeps
no such table."""


def read(r):
    try:
        from gnn_rul_tpu_torch import telemetry
    except ImportError:
        return None
    return telemetry.cold_start()["first_s"].get("serve.call")
