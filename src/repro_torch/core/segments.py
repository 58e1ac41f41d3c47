"""Multi-segment application modeling (paper §V-B 'Rodinia multi-segment
modeling').

Each application is a list of Segments (dominant GPU kernels or repeated
launch patterns).  Architecture-aware ROUTING maps each segment class to the
appropriate validated kernel family:

    stencil       -> memory-bound transpose proxy
    compute-bound -> GEMM family (stage / MFMA path)
    memory-bound  -> vector-copy family (bandwidth path)
    balanced      -> generic calibrated roofline

Segment times multiply by n_exec; host phases (memcpy/sync) add per Eq. 15.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from . import generic, predict as predict_mod
from .hardware import HardwareParams
from .workload import Segment, TimeBreakdown, Workload

# class -> model route per platform family (paper §V-B "architecture-aware
# routing").  GEMM-shaped compute segments take the native (stage/wavefront)
# path; everything else the generic calibrated path with its class scale.
CLASS_ROUTE = {
    "compute": "native",
    "memory": "generic",
    "stencil": "generic",
    "balanced": "generic",
}


def route_for(seg: Segment, hw: HardwareParams) -> str:
    route = CLASS_ROUTE[seg.workload.wclass]
    if route == "native" and (seg.workload.gemm is not None
                              or seg.workload.matrix):
        return {"blackwell": "stage", "cdna": "wavefront",
                "tpu": "tpu"}.get(hw.model_family, "generic")
    return "generic"


def predict_segment(seg: Segment, hw: HardwareParams, *,
                    calibration=None) -> TimeBreakdown:
    one = predict_mod.predict(seg.workload, hw, model=route_for(seg, hw),
                              calibration=calibration)
    out = one.scaled(seg.n_exec)
    overhead = generic.segment_overhead(seg, hw) * seg.n_exec
    return TimeBreakdown(
        total=out.total + overhead,
        compute=out.compute, memory=out.memory,
        io_effective=out.io_effective, sync=out.sync,
        launch=out.launch, writeback=out.writeback,
        collective=out.collective,
        overhead=overhead,
        detail=dict(out.detail, n_exec=float(seg.n_exec)),
    )


@dataclass(frozen=True)
class AppPrediction:
    name: str
    total: float
    per_segment: Dict[str, float]

    def mae_vs(self, measured: float) -> float:
        """Percent absolute error vs one measured total."""
        return abs(self.total - measured) / max(measured, 1e-30) * 100.0


def predict_app(name: str, segs: Sequence[Segment], hw: HardwareParams, *,
                calibration=None) -> AppPrediction:
    per: Dict[str, float] = {}
    total = 0.0
    for seg in segs:
        t = predict_segment(seg, hw, calibration=calibration).total
        per[seg.workload.name] = per.get(seg.workload.name, 0.0) + t
        total += t
    return AppPrediction(name=name, total=total, per_segment=per)
