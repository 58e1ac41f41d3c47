"""Dependency-free observability substrate of the port: a copy of
``repro.obs.metrics`` (thread-safe Counter / Gauge / Histogram primitives
behind a process-global named registry, rendered in Prometheus text
exposition format), which ``core.sweep`` and ``core.parallel`` record into.

The reference's ``trace`` module belongs to the serve stack and is not
ported yet (ROADMAP.md, Queue A).
"""
from . import metrics

__all__ = ["metrics"]
