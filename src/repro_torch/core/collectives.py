"""Mesh collective cost model (beyond-paper TPU extension; DESIGN.md §3).

The paper models single-GPU kernels and folds multi-device effects into an
interference term (N-1)*tau.  Our deployment is a 2x16x16 TPU v5e mesh, so
collectives are a first-class pipeline stage.  Ring algorithms on a 2D ICI
torus; the `pod` axis crosses slower DCI links.

Cost of moving B bytes (per-chip shard size) over an axis of size n:

    all-gather       : B * (n-1)          / BW_axis
    reduce-scatter   : B * (n-1) / n      / BW_axis   (B = full tensor/chip view)
    all-reduce       : 2 * B * (n-1) / n  / BW_axis   (RS + AG)
    all-to-all       : B * (n-1) / n      / BW_axis
    collective-permute: B                 / BW_axis   (one hop)

where BW_axis = links_per_axis * link_bw (bidirectional ring: a v5e chip has
one ICI link per mesh direction; both directions usable -> 2x).  We follow
the task-spec roofline convention (collective_bytes / (chips * link_bw)) for
the reported roofline TERM, and this richer model for predicted step time.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Mapping, Sequence, Tuple

from .hardware import HardwareParams

RING_FACTORS = {
    "all-gather": lambda n: float(n - 1),
    "reduce-scatter": lambda n: (n - 1) / n,
    "all-reduce": lambda n: 2.0 * (n - 1) / n,
    "all-to-all": lambda n: (n - 1) / n,
    "collective-permute": lambda n: 1.0,
}


@dataclass(frozen=True)
class MeshSpec:
    """Logical mesh: axis names -> sizes, and which axes are cross-pod."""

    axes: Tuple[Tuple[str, int], ...]          # ordered (name, size)
    slow_axes: Tuple[str, ...] = ("pod",)      # DCI-connected axes

    @property
    def num_devices(self) -> int:
        n = 1
        for _, s in self.axes:
            n *= s
        return n

    def size(self, axis: str) -> int:
        for name, s in self.axes:
            if name == axis:
                return s
        raise KeyError(f"axis {axis!r} not in mesh {self.axes}")


def axis_bandwidth(mesh: MeshSpec, axis: str, hw: HardwareParams) -> float:
    """Usable bytes/s along one mesh axis (both ring directions)."""
    if axis in mesh.slow_axes:
        return max(hw.dci_link_bw, 1.0) * 2.0
    return max(hw.ici_link_bw, 1.0) * hw.ici_links_per_axis * 2.0


def collective_time(op: str, shard_bytes: float, axis: str,
                    mesh: MeshSpec, hw: HardwareParams) -> float:
    """Seconds for one collective of `op` moving `shard_bytes` per chip."""
    if op not in RING_FACTORS:
        raise ValueError(f"unknown collective {op!r}")
    n = mesh.size(axis)
    if n <= 1:
        return 0.0
    bw = axis_bandwidth(mesh, axis, hw)
    return RING_FACTORS[op](n) * shard_bytes / bw


def schedule_time(ops: Sequence[Tuple[str, float, str]], mesh: MeshSpec,
                  hw: HardwareParams, *, overlap_alpha: float = 0.0
                  ) -> Dict[str, float]:
    """Total + exposed time of a collective schedule.

    ops: sequence of (op_name, shard_bytes, axis).
    overlap_alpha: fraction hidden behind compute (paper's alpha reused).
    Returns dict with total, exposed, and per-op breakdown.
    """
    per_op: Dict[str, float] = {}
    total = 0.0
    for op, nbytes, axis in ops:
        t = collective_time(op, nbytes, axis, mesh, hw)
        per_op[f"{op}@{axis}"] = per_op.get(f"{op}@{axis}", 0.0) + t
        total += t
    return {"total": total,
            "exposed": (1.0 - overlap_alpha) * total,
            **per_op}


def roofline_collective_term(collective_bytes: float, num_chips: int,
                             link_bw: float) -> float:
    """Task-spec roofline term: collective_bytes / (chips * link_bw)."""
    return collective_bytes / (max(num_chips, 1) * link_bw)
