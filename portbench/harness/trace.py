"""The device trace of a `--trace 1` run, reduced to what the per-layer
readers take: device activities, the host's ops and the harness's spans.

The trace is `torch.profiler` over CPU and CUDA; its events are read from
the profiler's Kineto results in memory, so nothing is written to disk.
Every time is in nanoseconds on the profiler's clock, on which the device's
activities are already aligned with the host's.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple

WINDOW_SPAN = "portbench.window"


@dataclass
class Span:
    name: str
    start: int
    end: int
    thread: int = 0      # the host thread of a host span
    kind: str = ""       # a device activity's: kernel, memcpy or memset

    @property
    def dur(self) -> int:
        return self.end - self.start


@dataclass
class Trace:
    """A traced window: ``device`` the card's activities (kernels, copies,
    fills) and ``host`` the host's ops and annotations, each clipped to
    nothing but sorted by start; ``window`` the harness's window span."""
    window: Span
    device: List[Span] = field(default_factory=list)
    memcpy: List[Span] = field(default_factory=list)
    host: List[Span] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return self.window.dur * 1e-9

    def spans(self, name: str) -> List[Span]:
        """The host spans (annotations or ops) named ``name`` inside the
        window."""
        return [s for s in self.host if s.name == name
                and s.start >= self.window.start and s.end <= self.window.end]

    def kernels(self, *fragments: str) -> List[Span]:
        """Device activities inside the window whose name holds any of
        ``fragments``."""
        return [s for s in self.device if any(f in s.name for f in fragments)]

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device's activities, clipped to the window."""
        lo, hi = self.window.start, self.window.end
        merged: List[Tuple[int, int]] = []
        for s in sorted(self.device, key=lambda s: s.start):
            a, b = max(s.start, lo), min(s.end, hi)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], b))
            else:
                merged.append((a, b))
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9


def _device_kind(name: str) -> str:
    if name.startswith("Memcpy"):
        return "memcpy"
    if name.startswith("Memset"):
        return "memset"
    return "kernel"


def from_profiler(prof) -> Trace:
    """The :class:`Trace` of a stopped ``torch.profiler.profile`` whose
    window was recorded under ``record_function(WINDOW_SPAN)``. A device
    event is a kernel, a copy (``Memcpy ...``) or a fill (``Memset
    ...``); the annotations the profiler mirrors onto the device's
    timeline are left out."""
    from torch.autograd import DeviceType

    window = None
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        start = e.start_ns()
        span = Span(name, start, start + e.duration_ns(),
                    e.start_thread_id())
        if e.device_type() == DeviceType.CUDA:
            if e.is_user_annotation() or name.startswith("portbench."):
                continue
            span.kind = _device_kind(name)
            device.append(span)
        elif name == WINDOW_SPAN:
            window = span
        else:
            host.append(span)
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN} span")
    device = [s for s in device
              if s.end > window.start and s.start < window.end]
    device.sort(key=lambda s: s.start)
    host = [s for s in host if s.thread == window.thread]
    host.sort(key=lambda s: (s.start, -s.end))
    return Trace(window, device, [s for s in device if s.kind == "memcpy"],
                 host)


def top_device_ops(trace: Trace, k: int = 10) -> List[list]:
    """The ``k`` device operations of most total time in the window, as
    ``[name, seconds]``."""
    totals: Dict[str, int] = {}
    lo, hi = trace.window.start, trace.window.end
    for s in trace.device:
        totals[s.name] = totals.get(s.name, 0) + max(
            0, min(s.end, hi) - max(s.start, lo))
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:k]
    return [[name[:64], ns * 1e-9] for name, ns in top]


def idle_gaps(trace: Trace, k: int = 10) -> List[list]:
    """The card's idle time in the window summed by what the host thread
    was doing at each gap's middle (its innermost op or span there), the
    ``k`` largest as ``[name, seconds]``."""
    busy = trace.busy_intervals()
    edges = [trace.window.start]
    for a, b in busy:
        edges += [a, b]
    edges.append(trace.window.end)
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    totals: Dict[str, int] = {}
    stack: List[Span] = []
    host = trace.host
    i = 0
    for a, b in gaps:
        mid = (a + b) // 2
        while i < len(host) and host[i].start <= mid:
            while stack and stack[-1].end <= host[i].start:
                stack.pop()
            stack.append(host[i])
            i += 1
        while stack and stack[-1].end < mid:
            stack.pop()
        name = stack[-1].name if stack else "(host outside any op)"
        totals[name] = totals.get(name, 0) + (b - a)
    top = sorted(totals.items(), key=lambda kv: -kv[1])[:k]
    return [[name[:64], ns * 1e-9] for name, ns in top]


class traced_window:
    """``with traced_window(on, device) as profiled:`` profiles the block
    under the window span when ``on`` (CPU and, on a card, CUDA);
    ``profiled.trace`` is then its :class:`Trace`, or None without a card
    or when off. Input shapes are not recorded: under ``torch.func.vmap``
    recording them keeps every batched input alive until the profiler
    stops (tens of GiB over a training window)."""

    def __init__(self, on: bool, device):
        self.on, self.device, self.trace = on, device, None

    def __enter__(self):
        if self.on:
            from torch.profiler import (ProfilerActivity, profile,
                                        record_function)
            cuda = self.device.type == "cuda"
            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                             if cuda else [])
            self._prof = profile(activities=acts)
            self._prof.__enter__()
            self._span = record_function(WINDOW_SPAN)
            self._span.__enter__()
        return self

    def __exit__(self, *exc):
        if self.on:
            self._span.__exit__(*exc)
            self._prof.__exit__(*exc)
            if exc[0] is None and self.device.type == "cuda":
                self.trace = from_profiler(self._prof)
            del self._prof
        return False
