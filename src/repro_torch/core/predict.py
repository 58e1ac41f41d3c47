"""Unified prediction entry point with architecture routing (paper §IV-C/D).

Workflow (paper §IV-D):
  1. characterize the workload (class, AI, working set, tiles),
  2. select the parameter file,
  3. apply the appropriate formula:
       Blackwell-family -> stage-centric model (core.blackwell)
       CDNA-family      -> wavefront-centric model (core.cdna3)
       TPU              -> TPU-adapted stage model (core.tpu)
       otherwise        -> generic calibrated roofline (core.generic)

Class-based routing for application segments mirrors §V-B: stencil ->
transpose proxy, compute-bound -> GEMM family, memory-bound -> vector copy.

Batched prediction
------------------
Scalar ``predict`` delegates to the shared ``core.sweep.SweepEngine`` as a
batch of one, so every call is memoized under a content key (Workload +
HardwareParams + route) and repeated autotune/hillclimb queries are O(1).
For sweeps — tile searches, precision ladders, portfolio pricing — call the
engine directly and amortize the Python dispatch over the whole batch:

    from repro_torch.core import hardware, sweep
    from repro_torch.core.workload import TileConfig, gemm_workload

    engine = sweep.default_engine()
    candidates = [gemm_workload("g", 8192, 8192, 8192,
                                tile=TileConfig(bm, bn, bk))
                  for bm in (64, 128, 256)
                  for bn in (64, 128, 256)
                  for bk in (32, 64, 128)]
    times = engine.predict_batch(candidates, hardware.B200)
    best = candidates[min(range(len(times)), key=lambda i: times[i].total)]

``predict_batch`` is NumPy-vectorized per route (10^3-10^4-point sweeps run
>=10x faster than a scalar loop; see benchmarks/sweep_bench.py) and
bit-identical to the scalar path (tests/test_sweep.py).
"""
from __future__ import annotations

from typing import Optional

from .hardware import HardwareParams
from .workload import TimeBreakdown, Workload


def predict(w: Workload, hw: HardwareParams, *,
            model: Optional[str] = None,
            calibration: Optional["object"] = None) -> TimeBreakdown:
    """Predict execution time of one kernel on one accelerator.

    ``model`` overrides routing: "stage" | "wavefront" | "generic" |
    "roofline" | "tpu".  ``calibration`` is an optional
    ``core.calibrate.Calibration`` applied multiplicatively per case.
    """
    from . import sweep
    return sweep.default_engine().predict(
        w, hw, model=model, calibration=calibration)


def _default_route(hw: HardwareParams) -> str:
    from . import sweep
    return sweep.default_route(hw)
