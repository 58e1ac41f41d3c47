"""Compute spans: the model's own layers, on the span ring of :mod:`.trace`.

``prefill`` (``train/serve_step.py``) is a root over the ``norm``,
``attention`` and ``mlp`` or ``ssm`` spans of its blocks
(``models/blocks.py``); ``train_step`` (``train/train_step.py``) is a
root over its phases ``forward_backward`` and ``optimizer``.  A root
mints the trace id its children share, and each span carries its own id
and its parent's.

They record only while a ``torch.profiler`` trace is being taken and the
metrics kill switch is on; otherwise a span site reads one flag and gets
a shared no-op context.  A span starts on ``time.time_ns()``, the clock
of the profiler's events, and is timed on ``time.perf_counter_ns()``.
While recording, a span on a CUDA device also records a CUDA event at
entry and exit on the stream that was current when its root opened; the
pair becomes seconds (``Span.device_s``) when first read, which waits for
the exit event.  On the CPU the device interval is the host interval.
The events come from a pool that grows in blocks and takes them back once
read.  Compute spans nest on one stack for the process: the thread that
runs the model opens them.
"""
from __future__ import annotations

import time
from typing import List, Optional

import torch

from . import metrics, trace

__all__ = ["DeviceInterval", "compute_span", "compute_spans", "evicted",
           "clear"]

_PROFILER = torch.autograd.profiler
_STACK: List["_Open"] = []  # the open compute spans, outermost first
_MUTED = 0                  # open spans that silence the spans inside them
_EVENTS: List = []          # CUDA timing events ready for reuse
_EVENT_BLOCK = 1024
_recorded = 0               # compute spans put in the ring since clear()


class DeviceInterval:
    """A compute span's seconds on its device: a pair of CUDA events
    recorded on the stream it ran on, turned into seconds when first read
    (waiting for the exit event), or, on the CPU, its host seconds."""

    __slots__ = ("_start", "_end", "_seconds")

    def __init__(self, start=None, end=None, seconds=None):
        self._start, self._end, self._seconds = start, end, seconds

    @property
    def seconds(self) -> float:
        if self._seconds is None:
            self._end.synchronize()
            self._seconds = self._start.elapsed_time(self._end) / 1e3
            _EVENTS.extend((self._start, self._end))
            self._start = self._end = None
        return self._seconds


class _Off:
    """The shared context of a span site while nothing records."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return None


_OFF = _Off()


def _event(stream):
    if not _EVENTS:
        _EVENTS.extend(torch.cuda.Event(enable_timing=True)
                       for _ in range(_EVENT_BLOCK))
    ev = _EVENTS.pop()
    ev.record(stream)
    return ev


class _Open:
    """A compute span being recorded; put in the ring on exit."""

    __slots__ = ("name", "attrs", "device", "leaf", "stream", "trace_id",
                 "span_id", "parent_id", "t0", "c0", "ev0")

    def __init__(self, name, key, value, device, leaf):
        self.name, self.device, self.leaf = name, device, leaf
        self.attrs = {} if key is None else {key: value}

    def __enter__(self):
        global _MUTED
        if _STACK:
            top = _STACK[-1]
            self.trace_id, self.parent_id = top.trace_id, top.span_id
            self.stream = top.stream
        else:
            self.trace_id, self.parent_id = trace.new_trace_id(), 0
            # looked up once a tree: current_stream() costs a launch's time
            self.stream = (torch.cuda.current_stream(self.device)
                           if getattr(self.device, "type", self.device)
                           == "cuda" else None)
        self.span_id = next(trace._IDS)
        _STACK.append(self)
        _MUTED += self.leaf
        self.t0, self.c0 = time.time_ns(), time.perf_counter_ns()
        self.ev0 = None if self.stream is None else _event(self.stream)
        return self

    def __exit__(self, exc_type, exc, tb):
        global _MUTED, _recorded
        ev1 = None if self.stream is None else _event(self.stream)
        host_s = (time.perf_counter_ns() - self.c0) / 1e9
        _STACK.pop()
        _MUTED -= self.leaf
        device = DeviceInterval(seconds=host_s) if ev1 is None \
            else DeviceInterval(self.ev0, ev1)
        trace._SPANS.append(trace.Span(
            self.name, self.trace_id, self.t0, host_s, self.attrs,
            self.span_id, self.parent_id, device))
        _recorded += 1
        return None


def compute_span(name: str, key: Optional[str] = None, value=None, *,
                 device=None, leaf: bool = False):
    """``with compute_span("prefill", "tokens", n, device=dev): ...``
    times a layer while a ``torch.profiler`` trace is being taken, else
    returns a shared no-op context.  A span opened with no compute span
    around it is a root: it mints a trace id, and ``device`` (a
    ``torch.device`` or its type) says whether its tree takes CUDA
    events.  A ``leaf`` span silences the spans opened inside it (a
    training step's phases: under remat the backward pass runs each
    block's forward again)."""
    if not _PROFILER._is_profiler_enabled or _MUTED \
            or not metrics.REGISTRY.enabled:
        return _OFF
    return _Open(name, key, value, device, leaf)


def compute_spans(name: Optional[str] = None) -> List[trace.Span]:
    """The compute spans in the ring, oldest first (by exit)."""
    return [s for s in trace.recent_spans(name=name) if s.device is not None]


def evicted() -> int:
    """Compute spans the ring has dropped since the last :func:`clear`."""
    return _recorded - len(compute_spans())


def clear() -> None:
    """Empty the span ring and the count of what it dropped."""
    global _recorded
    trace.clear_spans()
    _recorded = 0
