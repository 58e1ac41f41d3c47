"""Trace ids, span records, and the slow-request log.

A trace id is 16 lowercase hex characters (64 random bits), minted
once per logical client request and carried:

* over HTTP in the ``X-Repro-Trace`` header (:data:`TRACE_HEADER`);
* over both transports in the codec request meta as an *additive*
  ``trace_id`` field (binary framing v1 is untouched; v1 payloads
  without the field still decode).

Spans are lightweight completed-interval records (start, duration,
small attribute dict, their own id and their parent's) kept in a bounded
process-global ring so tests and the demo can ask "which spans did trace
X produce?" without an external collector.  Recording honours the
metrics kill switch (``metrics.set_enabled(False)`` silences spans too).

A span starts on ``time.time_ns()``, the clock of ``torch.profiler``'s
events, so it lays over a profiler trace as it stands; its duration is
taken on ``time.perf_counter_ns()``.  The ring also holds the model's
compute spans (:mod:`.compute`): a prefill or a training step and its
layers, recorded only while a ``torch.profiler`` trace is being taken,
on the same clock, each with the interval its work took on the device.
"""
from __future__ import annotations

import itertools
import json
import os
import random
import re
import sys
import threading
import time
from collections import deque
from contextlib import contextmanager
from typing import Callable, Dict, List, NamedTuple, Optional

from . import metrics

__all__ = [
    "TRACE_HEADER", "new_trace_id", "is_trace_id", "coerce_trace_id",
    "Span", "record_span", "recent_spans", "clear_spans", "span",
    "slow_log",
]

TRACE_HEADER = "X-Repro-Trace"

_TRACE_RE = re.compile(r"^[0-9a-f]{16}$")
_RNG = random.Random(int.from_bytes(os.urandom(8), "big"))
_RNG_LOCK = threading.Lock()


def new_trace_id() -> str:
    """A fresh 16-hex trace id (64 random bits)."""
    with _RNG_LOCK:
        return "%016x" % _RNG.getrandbits(64)


def is_trace_id(s) -> bool:
    return isinstance(s, str) and bool(_TRACE_RE.match(s))


def coerce_trace_id(value) -> Optional[str]:
    """A valid trace id or None — never raises on hostile input."""
    if isinstance(value, str):
        v = value.strip().lower()
        if _TRACE_RE.match(v):
            return v
    return None


class Span(NamedTuple):
    """One completed interval attributed to a trace."""

    name: str
    trace_id: str
    start_ns: int           # time.time_ns() at entry
    duration_s: float
    attrs: Dict
    span_id: int = 0
    parent_id: int = 0      # the span that opened this one; 0 for a root
    device: Optional[object] = None     # compute spans: its seconds there

    @property
    def start_s(self) -> float:
        return self.start_ns / 1e9

    @property
    def end_ns(self) -> int:
        return self.start_ns + round(self.duration_s * 1e9)

    @property
    def device_s(self) -> Optional[float]:
        """Seconds on the device (compute spans only)."""
        return None if self.device is None else self.device.seconds


#: a traced window holds ~100 requests of ~100 compute spans each
_SPANS_MAX = 1 << 16
#: deque appends are thread-safe and maxlen evicts in C — the record
#: path takes no lock; readers snapshot with a retry loop because
#: list(deque) raises RuntimeError if it races a concurrent append
_SPANS: deque = deque(maxlen=_SPANS_MAX)
_IDS = itertools.count(1)


def record_span(name: str, trace_id: Optional[str], duration_s: float,
                start_s: Optional[float] = None, **attrs) -> Optional[Span]:
    """Append a completed span to the ring; no-op without a trace id."""
    if not trace_id or not metrics.REGISTRY.enabled:
        return None
    if start_s is None:
        start_s = time.time_ns() / 1e9 - duration_s
    sp = Span(name, trace_id, round(start_s * 1e9), duration_s, attrs,
              next(_IDS))
    _SPANS.append(sp)
    return sp


def recent_spans(trace_id: Optional[str] = None,
                 name: Optional[str] = None) -> List[Span]:
    while True:
        try:
            out = list(_SPANS)
            break
        except RuntimeError:        # lost a race with an append
            continue
    if trace_id is not None:
        out = [s for s in out if s.trace_id == trace_id]
    if name is not None:
        out = [s for s in out if s.name == name]
    return out


def clear_spans() -> None:
    _SPANS.clear()


@contextmanager
def span(name: str, trace_id: Optional[str], **attrs):
    """``with span("client.attempt", tid): ...`` records on exit."""
    t0, c0 = time.time_ns(), time.perf_counter_ns()
    try:
        yield
    finally:
        record_span(name, trace_id, (time.perf_counter_ns() - c0) / 1e9,
                    start_s=t0 / 1e9, **attrs)


def slow_log(record: Dict,
             sink: Optional[Callable[[str], None]] = None) -> str:
    """Emit one structured slow-request line (JSON, sorted keys).

    The default sink writes to stderr.  Returns the serialized line so
    callers/tests can capture it without a sink.
    """
    line = json.dumps(record, sort_keys=True, separators=(",", ":"),
                      default=str)
    if sink is not None:
        sink(line)
    else:
        print(line, file=sys.stderr, flush=True)
    return line


def _reinit_after_fork_in_child() -> None:
    global _RNG_LOCK, _RNG
    _RNG_LOCK = threading.Lock()
    # re-seed so forked children don't mint identical trace ids
    _RNG = random.Random(int.from_bytes(os.urandom(8), "big"))


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reinit_after_fork_in_child)
