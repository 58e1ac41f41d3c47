"""Generic calibrated roofline path (paper §IV-F) + host phases (§IV-E).

Used when a segment does not map to a full Blackwell stage model or a
validated GEMM/tile case:
  * separate calibrated scales per class (memory / compute / balanced /
    stencil),
  * optional precision-specific tensor efficiency multipliers,
  * working-set-aware bandwidth B_eff(W) (Eq. 16),
  * multi-kernel segments: extra launch latency beyond the first kernel,
  * host-device transfer T_memcpy = S/B_eff + tau_memcpy (Eq. 15) and
    per-sync-point T_host_sync = tau_sync.

Sustained (microbenchmark) values drive this path; datasheet peaks are kept
for upper-bound comparisons only (paper §V-A).
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .cache import working_set_blend, working_set_blend_batch
from .hardware import HardwareParams
from .workload import HostPhase, Row, Segment, TimeBreakdown, Workload, \
    tb_from_row


def predict(w: Workload, hw: HardwareParams, *,
            class_scale: float = 0.0) -> TimeBreakdown:
    """Generic roofline with calibrated class scale + Eq. 16 blend."""
    scale = class_scale or hw.class_scales.get(w.wclass, 1.0)
    bw = working_set_blend(w.working_set_bytes or w.bytes, hw)
    t_mem = w.bytes / bw
    eff = hw.precision_efficiency.get(w.precision, 1.0)
    rate = hw.sustained_flops(w.precision, matrix=w.matrix) * eff
    t_comp = w.flops / rate if w.flops > 0 else 0.0
    if w.irregular:
        t_mem *= 4.0
    body = max(t_comp, t_mem) * scale
    total = hw.launch_latency_s + body
    total += (w.concurrent_kernels - 1) * hw.tau_interference_s
    total += (w.num_devices - 1) * hw.tau_interference_gpu_s
    return TimeBreakdown(total=total, compute=t_comp, memory=t_mem,
                         io_effective=t_mem,
                         launch=hw.launch_latency_s,
                         detail={"bw_eff": bw, "class_scale": scale})


def predict_table_cols(table, hw: HardwareParams):
    """Columnar ``predict`` over a WorkloadTable (class_scale taken from the
    parameter file, as in the scalar default).  Bit-identical per row to
    scalar ``predict(w, hw)``."""
    from .workload import NV_BYTES, NV_WS_OR_BYTES, NV_FLOPS, \
        NV_IRREGULAR, NV_CONCURRENT, NV_DEVICES, TableCols
    raw = table.cols
    nbytes, wsb, flops = raw[:, NV_BYTES], raw[:, NV_WS_OR_BYTES], \
        raw[:, NV_FLOPS]
    scale = table.per_wclass(lambda c: hw.class_scales.get(c, 1.0))
    bw = working_set_blend_batch(wsb, hw)
    t_mem = nbytes / bw

    rate = table.per_precision_matrix(
        lambda p, m: hw.sustained_flops(p, matrix=m)
        * hw.precision_efficiency.get(p, 1.0))
    with np.errstate(divide="ignore", invalid="ignore"):
        t_comp = np.where(flops > 0, flops / rate, 0.0)
    t_mem = np.where(raw[:, NV_IRREGULAR] != 0, t_mem * 4.0, t_mem)
    body = np.maximum(t_comp, t_mem) * scale
    total = hw.launch_latency_s + body
    total = total + (raw[:, NV_CONCURRENT] - 1) * hw.tau_interference_s
    total = total + (raw[:, NV_DEVICES] - 1) * hw.tau_interference_gpu_s

    return TableCols(
        len(table),
        (total, t_comp, t_mem, t_mem, 0.0, hw.launch_latency_s,
         0.0, 0.0, 0.0),
        ("bw_eff", "class_scale"), (bw, scale))


def predict_rows(ws: Sequence[Workload],
                 hw: HardwareParams) -> List[Row]:
    """Vectorized ``predict`` over a workload batch, in row form.
    Bit-identical to per-workload ``predict(w, hw)`` calls."""
    from .workload import WorkloadTable
    return predict_table_cols(WorkloadTable.from_workloads(ws), hw).rows()


def predict_batch(ws: Sequence[Workload],
                  hw: HardwareParams) -> List[TimeBreakdown]:
    """Materialized form of ``predict_rows``."""
    return [tb_from_row(r) for r in predict_rows(ws, hw)]


def host_phase_time(phase: HostPhase, hw: HardwareParams) -> float:
    """Eq. 15 / §IV-E. Conservative: no copy/compute overlap modeled."""
    if phase.kind == "sync":
        return phase.count * hw.tau_sync_s
    bw = hw.h2d_bandwidth if phase.kind == "h2d" else hw.d2h_bandwidth
    return phase.count * (phase.bytes / bw + hw.tau_memcpy_s)


def segment_overhead(seg: Segment, hw: HardwareParams) -> float:
    """Host phases + extra kernel launches (multi-kernel segments)."""
    t = sum(host_phase_time(p, hw) for p in seg.host_phases)
    t += seg.extra_kernels * hw.launch_latency_s
    return t
