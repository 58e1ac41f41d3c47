"""The program's compute spans (``repro_torch.obs.compute``) of a traced
window, for the per-layer metrics that read them.

The program records compute spans only while a profiler trace is being
taken, so the ring holds the traced window's alone: set-up, warm-up and
the reference run untraced.  A root (``prefill`` or ``train_step``) is one
request or step; its children share its trace id.
"""
from __future__ import annotations


def traced(t, root: str):
    """(roots, every compute span of their traces), or None where the
    program records no compute spans, the ring dropped any, or the roots
    are not one a traced request (``prefill``) or step (``train_step``)."""
    try:
        from repro_torch.obs import compute
    except ImportError:
        return None
    if compute.evicted():
        return None
    spans = compute.compute_spans()
    roots = [s for s in spans if s.parent_id == 0 and s.name == root]
    want = len(t.prompts) if root == "prefill" else t.steps
    if not roots or len(roots) != want:
        return None
    ids = {s.trace_id for s in roots}
    return roots, [s for s in spans if s.trace_id in ids]


def device_us_per_token(t, name: str):
    """Device microseconds of the traced requests' ``name`` spans over
    their prompt tokens, or None where there are none."""
    got = traced(t, "prefill")
    if got is None:
        return None
    roots, spans = got
    secs = [s.device_s for s in spans if s.name == name]
    if not secs:
        return None
    return 1e6 * sum(secs) / sum(r.attrs["tokens"] for r in roots)
