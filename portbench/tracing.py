"""The traced window's reduction: from a ``torch.profiler`` trace to the
card's busy time, each kernel's device time, and the idle gaps named by
what the host was doing.

Only the raw kineto events are read (``prof.profiler.kineto_results``), so
no per-event Python object is built for the tens of thousands of kernels of
a window.  Device events are the kernels, copies and sets on the card;
the card-side copies of host annotations are left out, since they span
idle time too.
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

WINDOW_SPAN = "portbench.traced_window"
SYNC = "cudaDeviceSynchronize"
SHORT_GAP_NS = 20_000          # idle gaps shorter than this are lumped
TOP = 10


def _is_device(e) -> bool:
    from torch.autograd import DeviceType
    if e.device_type() != DeviceType.CUDA or e.is_user_annotation():
        return False
    # torch 2.11's events have no activity_type (newer ones do)
    kind = e.activity_type() if hasattr(e, "activity_type") else ""
    return "annotation" not in kind


def raw_events(prof) -> Tuple[list, list]:
    """(device events, host events) as (start_ns, end_ns, name)."""
    dev, host = [], []
    for e in prof.profiler.kineto_results.events():
        item = (e.start_ns(), e.end_ns(), e.name())
        (dev if _is_device(e) else host).append(item)
    return dev, host


def merged(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def reduce(dev: list, host: list) -> dict:
    """The traced window (the host span ``WINDOW_SPAN`` or, where only the
    card's activity was traced, from the end of its first device
    synchronise to the end of its last) and, inside it:
    busy seconds (the union of device intervals), device seconds by kernel
    name, the top device ops and the idle gaps summed by the innermost host
    event that covers each gap's middle."""
    spans = [(s, e) for s, e, n in host if n == WINDOW_SPAN]
    syncs = sorted(e for _, e, n in host if n == SYNC)
    if spans:
        ws, we = spans[0]
    elif len(syncs) >= 2:
        ws, we = syncs[0], syncs[-1]
    else:
        raise RuntimeError(f"the trace holds no {WINDOW_SPAN!r} span and "
                           f"{len(syncs)} {SYNC} calls")
    clipped = [(max(s, ws), min(e, we), n) for s, e, n in dev
               if e > ws and s < we]
    busy = merged([(s, e) for s, e, _ in clipped])
    kernels: Dict[str, float] = defaultdict(float)
    for s, e, n in clipped:
        kernels[n] += (e - s) / 1e9
    edges = [ws] + [x for iv in busy for x in iv] + [we]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    inner = sorted((s, e, n) for s, e, n in host if n != WINDOW_SPAN)
    starts = [s for s, _, _ in inner]
    idle: Dict[str, float] = defaultdict(float)
    for s, e in gaps:
        if e - s < SHORT_GAP_NS:
            idle["gaps under 20 us"] += (e - s) / 1e9
            continue
        mid = (s + e) // 2
        label = "no host event"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 5000, -1), -1):
            if inner[j][1] >= mid:
                label = inner[j][2]
                break
        idle["host: " + label[:120]] += (e - s) / 1e9
    busy_s = sum(e - s for s, e in busy) / 1e9

    def top(d):
        return [[k[:160], v] for k, v in
                sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"window_s": (we - ws) / 1e9, "busy_s": busy_s,
            "kernels": dict(kernels),
            "breakdown": {"device_ops": top(kernels), "idle_gaps": top(idle)}}
