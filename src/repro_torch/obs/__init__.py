"""Dependency-free observability substrate of the port: copies of
``repro.obs.metrics`` (thread-safe Counter / Gauge / Histogram primitives
behind a process-global named registry, rendered in Prometheus text
exposition format), which ``core.sweep``, ``core.parallel`` and the serve
stack record into, and ``repro.obs.trace`` (16-hex trace ids, bounded
in-process span records, and the ``X-Repro-Trace`` propagation contract
the serve stack speaks).
"""
from . import metrics, trace

__all__ = ["metrics", "trace"]
