"""Naive roofline baseline (paper §II-A, Table VI context column).

    T_roofline = max(FLOPs / P_peak, bytes / B_HBM)

Uses ONLY datasheet peaks, ignores cache hierarchies, pipeline stages,
occupancy and launch latency — by design.  The paper keeps it as context to
show why architecture-specific modeling is necessary (>94% error on all
platforms).  We implement it verbatim so benchmarks can reproduce that gap.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .hardware import HardwareParams
from .workload import Row, TimeBreakdown, Workload, tb_from_row


def predict(w: Workload, hw: HardwareParams) -> TimeBreakdown:
    """Naive roofline prediction: datasheet peaks only."""
    peak = hw.peak_flops(w.precision, matrix=w.matrix)
    t_compute = w.flops / peak if peak > 0 else 0.0
    t_memory = w.bytes / hw.hbm_peak_bw if hw.hbm_peak_bw > 0 else 0.0
    total = max(t_compute, t_memory)
    return TimeBreakdown(total=total, compute=t_compute, memory=t_memory,
                         detail={"path": 0.0})


def predict_table_cols(table, hw: HardwareParams):
    """Columnar ``predict`` over a WorkloadTable (bit-identical per row)."""
    from .workload import NV_BYTES, NV_FLOPS, TableCols
    raw = table.cols
    peak = table.per_precision_matrix(
        lambda p, m: hw.peak_flops(p, matrix=m))
    flops, nbytes = raw[:, NV_FLOPS], raw[:, NV_BYTES]
    with np.errstate(divide="ignore", invalid="ignore"):
        t_compute = np.where(peak > 0, flops / peak, 0.0)
    if hw.hbm_peak_bw > 0:
        t_memory = nbytes / hw.hbm_peak_bw
    else:
        t_memory = np.zeros_like(nbytes)
    total = np.maximum(t_compute, t_memory)
    return TableCols(
        len(table),
        (total, t_compute, t_memory, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0),
        ("path",), (0.0,))


def predict_rows(ws: Sequence[Workload],
                 hw: HardwareParams) -> List[Row]:
    """Vectorized ``predict`` over a workload batch, in row form
    (bit-identical)."""
    from .workload import WorkloadTable
    return predict_table_cols(WorkloadTable.from_workloads(ws), hw).rows()


def predict_batch(ws: Sequence[Workload],
                  hw: HardwareParams) -> List[TimeBreakdown]:
    """Materialized form of ``predict_rows``."""
    return [tb_from_row(r) for r in predict_rows(ws, hw)]


def ridge_intensity(hw: HardwareParams, precision: str = "fp16",
                    matrix: bool = True) -> float:
    """Arithmetic intensity at the roofline ridge point (FLOPs/byte)."""
    return hw.peak_flops(precision, matrix) / hw.hbm_peak_bw
