"""Spans at the port's layer boundaries, and the time of a process's first
answer by layer.

``span(name)`` marks one layer's work. While a ``torch.profiler`` records,
it is ``torch.profiler.record_function(name)``: the span lands in the
profiler's trace beside the card's activities, on the clock they are
aligned to, so any profiler window (``--profile`` too) shows it. Otherwise
it is a shared null context, one flag check. Nothing is recorded while
``torch.export`` or ``torch.compile`` traces a forward, so an exported
program holds no span.

A span made with ``first=True`` also times its first occurrence in the
process on the host's clock, profiler or not; later ones skip the clock.
``cold_start()`` returns those times with the counters :func:`count` adds
to (``kernels.compiled``: nvcc runs in this process). The table belongs to
the process: a serving process reads its own time to its first answer.

The spans, by layer: ``serve.call`` ⊃ ``serve.stage_in``,
``serve.forward``, ``serve.fetch_out`` (``export.py::ServingModel``, all
``first=True``); ``hagcn.*`` (``models/hagcn.py``),
``logo_bearing.front_end`` and ``logo.*`` (``models/logo_bearing.py``,
``models/logo.py``); ``kernels.load.<family>`` (each kernel wrapper's
``load``, ``first=True``); ``train.step`` and ``train.eval`` (both
engines).
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict

import torch
from torch.autograd import profiler as _profiler

_NULL = contextlib.nullcontext()
_first_s: Dict[str, float] = {}
_counts: Dict[str, int] = {}
_lock = threading.Lock()   # guards both tables


def _recording() -> bool:
    """A profiler records and no tracer is turning the code into a
    graph."""
    return (_profiler._is_profiler_enabled
            and not torch.compiler.is_compiling())


class _First:
    """A ``first=True`` span's first occurrence: the span as any other,
    and its seconds kept in the cold-start table when it ends without an
    exception."""

    __slots__ = ("name", "_t0", "_inner")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self._inner = (_profiler.record_function(self.name) if _recording()
                       else _NULL)
        self._inner.__enter__()
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            seconds = (time.perf_counter_ns() - self._t0) * 1e-9
            with _lock:
                _first_s.setdefault(self.name, seconds)
        return self._inner.__exit__(*exc)


def span(name: str, first: bool = False):
    """A context manager marking ``name``'s work; ``first=True`` times its
    first occurrence in the process (:func:`cold_start`)."""
    if first and name not in _first_s:
        return _First(name)
    return _profiler.record_function(name) if _recording() else _NULL


def count(name: str, n: int) -> None:
    """Add ``n`` to the process's counter ``name`` (:func:`cold_start`)."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def cold_start() -> Dict[str, Dict]:
    """``{"first_s": {span: seconds of its first occurrence}, "counts":
    {counter: value}}`` of this process so far."""
    with _lock:
        return {"first_s": dict(_first_s), "counts": dict(_counts)}
