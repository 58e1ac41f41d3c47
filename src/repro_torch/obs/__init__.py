"""Dependency-free observability substrate of the port: copies of
``repro.obs.metrics`` (thread-safe Counter / Gauge / Histogram primitives
behind a process-global named registry, rendered in Prometheus text
exposition format), which ``core.sweep``, ``core.parallel`` and the serve
stack record into, and ``repro.obs.trace`` (16-hex trace ids, bounded
in-process span records, and the ``X-Repro-Trace`` propagation contract
the serve stack speaks), its spans stamped on the profiler's clock.

``obs.compute`` (imported by the model code, not here: it loads torch)
puts compute spans on the same ring: a prefill or a training step is a
root, its blocks' norms, attention, MLP or SSM mixer (or its
forward-backward and optimizer phases) its children.  They record only
while a ``torch.profiler`` trace is being taken and the metrics kill
switch is on, and carry both a host interval, starting on
``time.time_ns()`` (the clock of the profiler's events), and a device
interval (CUDA events on the root's stream, or the host interval on the
CPU).
"""
from . import metrics, trace

__all__ = ["metrics", "trace"]
