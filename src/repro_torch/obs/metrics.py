"""Thread-safe metrics primitives with a process-global named registry.

Design constraints (see serve/README.md "Observability"):

* stdlib only — no prometheus_client, no numpy;
* near-free when disabled: every mutation starts with one attribute
  load and a branch on ``Registry.enabled``, so ``--metrics off`` costs
  a handful of nanoseconds per call site;
* histograms use *fixed* bucket ladders (log-spaced) so series never
  change shape at runtime and the exposition is a stable contract;
* metric names are append-only once shipped — renaming or deleting a
  family is a breaking change for scrapers.

Series identity is ``(name, sorted(labels))``.  ``counter()`` /
``gauge()`` / ``histogram()`` are get-or-create and idempotent, so call
sites can simply re-ask the registry at construction time; registering
the same name with a different metric kind raises ``ValueError``.
"""
from __future__ import annotations

import os
import re
import threading
from bisect import bisect_left
from collections import deque
from typing import Dict, Iterable, List, Optional, Tuple

__all__ = [
    "LATENCY_BUCKETS_S", "COUNT_BUCKETS",
    "Counter", "Gauge", "Histogram", "Registry", "REGISTRY",
    "counter", "gauge", "histogram",
    "render_prometheus", "snapshot", "set_enabled", "enabled",
]

# Fixed log-spaced ladders.  Latency: 1 us .. 50 s, three buckets per
# decade (1 / 2.5 / 5).  Sizes: powers of two, 1 .. ~1M rows.
LATENCY_BUCKETS_S: Tuple[float, ...] = tuple(
    float("%se%d" % (m, e)) for e in range(-6, 2) for m in ("1", "2.5", "5"))
COUNT_BUCKETS: Tuple[float, ...] = tuple(float(2 ** k) for k in range(21))

#: recent exemplars kept per histogram series (a fused batch can land
#: several trace-carrying observations back-to-back; one slot would
#: keep only the last request's id)
EXEMPLAR_RING = 8

_NAME_RE = re.compile(r"^[a-zA-Z_:][a-zA-Z0-9_:]*$")
_LABEL_RE = re.compile(r"^[a-zA-Z_][a-zA-Z0-9_]*$")


def _fmt(v: float) -> str:
    """Prometheus sample value: integers without a trailing ``.0``."""
    f = float(v)
    if f == int(f) and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


def _escape(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


class _Series:
    """Base: one (name, labels) time series owned by a registry."""

    kind = "untyped"
    __slots__ = ("name", "labels", "_reg", "_lock")

    def __init__(self, reg: "Registry", name: str,
                 labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self._reg = reg
        self._lock = threading.Lock()

    def _label_str(self, extra: str = "") -> str:
        parts = [f'{k}="{_escape(v)}"' for k, v in self.labels]
        if extra:
            parts.append(extra)
        return "{" + ",".join(parts) + "}" if parts else ""


class Counter(_Series):
    """Monotonically increasing float counter."""

    kind = "counter"
    __slots__ = ("_value",)

    def __init__(self, reg, name, labels):
        super().__init__(reg, name, labels)
        self._value = 0.0

    def inc(self, n: float = 1.0) -> None:
        if not self._reg.enabled:
            return
        if n < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += n

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def _render(self) -> List[str]:
        return [f"{self.name}{self._label_str()} {_fmt(self.value)}"]

    def _snapshot(self) -> Dict:
        return {"labels": dict(self.labels), "value": self.value}


class Gauge(_Series):
    """Instantaneous value that can move both ways."""

    kind = "gauge"
    __slots__ = ("_value",)

    def __init__(self, reg, name, labels):
        super().__init__(reg, name, labels)
        self._value = 0.0

    def set(self, v: float) -> None:
        if not self._reg.enabled:
            return
        # a single attribute store is atomic under the GIL; the lock is
        # only needed for read-modify-write (inc/dec), so the hot-path
        # set (queue depth, inflight — twice per request) skips it
        self._value = float(v)

    def inc(self, n: float = 1.0) -> None:
        if not self._reg.enabled:
            return
        with self._lock:
            self._value += n

    def dec(self, n: float = 1.0) -> None:
        self.inc(-n)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    _render = Counter._render
    _snapshot = Counter._snapshot


class Histogram(_Series):
    """Fixed-bucket histogram with a small ring of recent exemplars.

    ``observe(v, trace_id=...)`` attaches the trace id of the
    observation as an exemplar; the last :data:`EXEMPLAR_RING` of them
    are kept per series, which is how a request id stays findable from
    the metrics side even when a fused batch lands several observations
    back-to-back (the text exposition stays plain Prometheus; exemplars
    live in :meth:`Registry.snapshot`).
    """

    kind = "histogram"
    __slots__ = ("buckets", "_counts", "_sum", "_count", "_exemplars")

    def __init__(self, reg, name, labels,
                 buckets: Iterable[float] = LATENCY_BUCKETS_S):
        super().__init__(reg, name, labels)
        self.buckets = tuple(sorted(float(b) for b in buckets))
        if not self.buckets:
            raise ValueError("histogram needs at least one bucket bound")
        self._counts = [0] * (len(self.buckets) + 1)   # last = +Inf
        self._sum = 0.0
        self._count = 0
        self._exemplars: deque = deque(maxlen=EXEMPLAR_RING)

    def observe(self, v: float, trace_id: Optional[str] = None) -> None:
        # hot path: several observes per served request — no float()
        # coercion (callers pass time deltas / row counts), bucket
        # search outside the lock, plain acquire/release
        if not self._reg.enabled:
            return
        i = bisect_left(self.buckets, v)
        lock = self._lock
        lock.acquire()
        try:
            self._counts[i] += 1
            self._sum += v
            self._count += 1
            if trace_id is not None:
                self._exemplars.append((trace_id, v))
        finally:
            lock.release()

    @property
    def count(self) -> int:
        with self._lock:
            return self._count

    @property
    def sum(self) -> float:
        with self._lock:
            return self._sum

    @property
    def exemplar(self) -> Optional[Tuple[str, float]]:
        """The most recent exemplar, or None."""
        with self._lock:
            return self._exemplars[-1] if self._exemplars else None

    @property
    def exemplars(self) -> List[Tuple[str, float]]:
        """The recent-exemplar ring, oldest first."""
        with self._lock:
            return list(self._exemplars)

    def _render(self) -> List[str]:
        with self._lock:
            counts, total, count = list(self._counts), self._sum, self._count
        out, cum = [], 0
        for bound, c in zip(self.buckets, counts):
            cum += c
            le = 'le="%s"' % _fmt(bound)
            out.append(f"{self.name}_bucket{self._label_str(le)} {cum}")
        inf = 'le="+Inf"'
        out.append(f"{self.name}_bucket{self._label_str(inf)} {count}")
        out.append(f"{self.name}_sum{self._label_str()} {_fmt(total)}")
        out.append(f"{self.name}_count{self._label_str()} {count}")
        return out

    def _snapshot(self) -> Dict:
        with self._lock:
            counts = list(self._counts)
            snap = {
                "labels": dict(self.labels),
                "sum": self._sum,
                "count": self._count,
                "buckets": [[b, c] for b, c in zip(self.buckets, counts)],
                "inf": counts[-1],
            }
            if self._exemplars:
                last = self._exemplars[-1]
                snap["exemplar"] = {"trace_id": last[0], "value": last[1]}
                snap["exemplars"] = [{"trace_id": t, "value": v}
                                     for t, v in self._exemplars]
        return snap


class Registry:
    """Named collection of series; one process-global instance below."""

    def __init__(self, enabled: bool = True):
        self.enabled = enabled
        self._lock = threading.Lock()
        self._families: Dict[str, Tuple[str, str]] = {}   # name -> kind, help
        self._series: Dict[Tuple[str, Tuple], _Series] = {}

    # -- get-or-create ------------------------------------------------
    def _get(self, cls, name: str, help: str, labels: Dict[str, str],
             **kw) -> _Series:
        if not _NAME_RE.match(name):
            raise ValueError(f"bad metric name: {name!r}")
        for k in labels:
            if not _LABEL_RE.match(k):
                raise ValueError(f"bad label name: {k!r}")
        key = (name, tuple(sorted((k, str(v)) for k, v in labels.items())))
        with self._lock:
            fam = self._families.get(name)
            if fam is None:
                self._families[name] = (cls.kind, help)
            elif fam[0] != cls.kind:
                raise ValueError(f"metric {name!r} already registered as "
                                 f"{fam[0]}, not {cls.kind}")
            s = self._series.get(key)
            if s is None:
                s = cls(self, name, key[1], **kw)
                self._series[key] = s
            return s

    def counter(self, name: str, help: str = "", **labels) -> Counter:
        return self._get(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", **labels) -> Gauge:
        return self._get(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "",
                  buckets: Iterable[float] = LATENCY_BUCKETS_S,
                  **labels) -> Histogram:
        return self._get(Histogram, name, help, labels, buckets=buckets)

    # -- export -------------------------------------------------------
    def _ordered(self) -> List[Tuple[str, str, str, List[_Series]]]:
        with self._lock:
            fams = dict(self._families)
            series = list(self._series.items())
        by_name: Dict[str, List[Tuple[Tuple, _Series]]] = {}
        for (name, lbls), s in series:
            by_name.setdefault(name, []).append((lbls, s))
        out = []
        for name in sorted(by_name):
            kind, help = fams[name]
            out.append((name, kind, help,
                        [s for _, s in sorted(by_name[name],
                                              key=lambda p: p[0])]))
        return out

    def render_prometheus(self) -> str:
        """Prometheus text exposition (format version 0.0.4)."""
        lines: List[str] = []
        for name, kind, help, series in self._ordered():
            if help:
                lines.append(f"# HELP {name} {_escape(help)}")
            lines.append(f"# TYPE {name} {kind}")
            for s in series:
                lines.extend(s._render())
        return "\n".join(lines) + "\n" if lines else ""

    def snapshot(self) -> Dict:
        """Structured dict view (includes histogram exemplars)."""
        out: Dict = {}
        for name, kind, help, series in self._ordered():
            out[name] = {"kind": kind, "help": help,
                         "series": [s._snapshot() for s in series]}
        return out

    def family_names(self) -> List[str]:
        with self._lock:
            return sorted(self._families)

    def reset(self) -> None:
        """Drop every family and series (tests only)."""
        with self._lock:
            self._families.clear()
            self._series.clear()


REGISTRY = Registry()


def counter(name: str, help: str = "", **labels) -> Counter:
    return REGISTRY.counter(name, help, **labels)


def gauge(name: str, help: str = "", **labels) -> Gauge:
    return REGISTRY.gauge(name, help, **labels)


def histogram(name: str, help: str = "",
              buckets: Iterable[float] = LATENCY_BUCKETS_S,
              **labels) -> Histogram:
    return REGISTRY.histogram(name, help, buckets=buckets, **labels)


def render_prometheus() -> str:
    return REGISTRY.render_prometheus()


def snapshot() -> Dict:
    return REGISTRY.snapshot()


def set_enabled(on: bool) -> None:
    """Process-wide kill switch (the server's ``--metrics off|on``)."""
    REGISTRY.enabled = bool(on)


def enabled() -> bool:
    return REGISTRY.enabled


def _reinit_after_fork_in_child() -> None:
    # A forked worker must not inherit possibly-held locks; series
    # values are fine to keep (the child's registry is its own copy).
    REGISTRY._lock = threading.Lock()
    for s in REGISTRY._series.values():
        s._lock = threading.Lock()


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_reinit_after_fork_in_child)
