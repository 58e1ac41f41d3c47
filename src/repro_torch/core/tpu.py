"""TPU v5e adaptation of the paper's stage-centric model (DESIGN.md §3).

TPU execution has Blackwell-like *explicit* stages — compiler-scheduled
HBM->VMEM DMA (the TMA analogue), VMEM-resident tiles/accumulators (the TMEM
analogue), the MXU systolic array (the tensor-core analogue) — plus a stage
the paper lacks: ICI/DCI collectives.  Following the paper's structure:

    T_step = max(T_mxu + T_vpu, T_io_eff, T_coll_exposed) + T_sync
    T_io_eff = (1 - alpha) * T_dma                                (Eq. 7)
    T_dma    = L_dma + bytes / B_eff(W)                           (Eq. 4/16)
    T_mxu    = matrix_flops / (197 TF/s * util(precision, align))
    T_coll   = ring model per core.collectives
    T_total  = T_launch + T_step + (N-1) * tau_interf  (straggler budget)

There is no occupancy (one program per core); overlap is the compiler's
double/triple-buffering, so we reuse the paper's alpha in [0.85, 0.95].

This module is also the consumer of dry-run artifacts: ``from_cost_analysis``
builds a Workload from compiled.cost_analysis() + parsed collective bytes,
and ``roofline_report`` emits the three task-spec roofline terms.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np


from . import collectives as coll
from .cache import working_set_blend, working_set_blend_batch
from .hardware import BYTES_PER_ELEM, HardwareParams, TPU_V5E
from .workload import Row, TimeBreakdown, Workload, tb_from_row


def mxu_utilization(w: Workload, hw: HardwareParams) -> float:
    """MXU efficiency: precision factor x dimension-alignment factor.

    The MXU is a 128x128 systolic array; matmul dims not multiples of 128
    waste lanes (paper's S_mode / utilization analogue, re-derived for TPU).
    """
    eff = hw.precision_efficiency.get(w.precision, 1.0)
    if w.gemm is not None:
        for dim in (w.gemm.m, w.gemm.n, w.gemm.k):
            if dim % 128 != 0:
                pad = 128 * -(-dim // 128)
                eff *= dim / pad
    return eff


def dma_time(w: Workload, hw: HardwareParams) -> float:
    """HBM->VMEM DMA stage (TMA analogue): latency + bytes / B_eff(W)."""
    bw = working_set_blend(w.working_set_bytes or w.bytes, hw)
    t = hw.cycles_to_seconds(hw.tma_latency_cycles) + w.bytes / bw
    if w.irregular:
        t *= 4.0
    return t


def compute_time(w: Workload, hw: HardwareParams) -> float:
    """MXU + VPU stages. Matrix FLOPs ride the MXU; the rest ride the VPU."""
    if w.matrix:
        rate = hw.sustained_flops(w.precision, matrix=True)
        return w.flops / (rate * mxu_utilization(w, hw)
                          / hw.precision_efficiency.get(w.precision, 1.0))
    rate = hw.sustained_flops(w.precision, matrix=False)
    return w.flops / rate if w.flops > 0 else 0.0


def predict(w: Workload, hw: HardwareParams = TPU_V5E, *,
            mesh: Optional[coll.MeshSpec] = None,
            collective_ops: Sequence[Tuple[str, float, str]] = (),
            coll_overlap: Optional[float] = None) -> TimeBreakdown:
    """Stage-centric TPU prediction."""
    t_comp = compute_time(w, hw)
    t_dma = dma_time(w, hw)
    alpha = hw.pipeline_overlap_alpha
    t_sync = hw.cycles_to_seconds(hw.mbarrier_latency_cycles)
    t_io_eff = (1.0 - alpha) * t_dma + t_sync                    # Eq. 7

    t_coll = t_coll_exposed = 0.0
    if mesh is not None and collective_ops:
        a = alpha if coll_overlap is None else coll_overlap
        sched = coll.schedule_time(collective_ops, mesh, hw, overlap_alpha=a)
        t_coll, t_coll_exposed = sched["total"], sched["exposed"]

    t_step = max(t_comp, t_io_eff, t_coll_exposed) + t_sync      # Eq. 8
    total = hw.launch_latency_s + t_step
    total += (w.num_devices - 1) * 0.0  # SPMD: no per-device serial term;
    # straggler budget is reported separately (see straggler_budget()).
    return TimeBreakdown(
        total=total, compute=t_comp, memory=t_dma, io_effective=t_io_eff,
        sync=t_sync, launch=hw.launch_latency_s, collective=t_coll,
        detail={"t_coll_exposed": t_coll_exposed,
                "mxu_util": mxu_utilization(w, hw) if w.matrix else 0.0,
                "alpha": alpha},
    )


# ---------------------------------------------------------------------------
# Columnar (NumPy-vectorized) stage model — the WorkloadTable / SweepEngine
# hot path.  No mesh/collectives in batch mode (matching the scalar
# default); results are bit-identical to per-workload ``predict(w, hw)``.
# ---------------------------------------------------------------------------

def _mxu_utilization_batch(raw: np.ndarray, eff: np.ndarray) -> np.ndarray:
    from .workload import NV_GM, NV_GN, NV_GK, NV_HAS_GEMM
    has_gemm = raw[:, NV_HAS_GEMM] != 0
    util = eff
    for col in (NV_GM, NV_GN, NV_GK):
        dim = np.where(has_gemm, raw[:, col], 128.0)
        pad = 128 * -(-dim // 128)
        factor = np.where(dim % 128 != 0, dim / pad, 1.0)
        util = util * factor
    return util


def predict_table_cols(table, hw: HardwareParams = TPU_V5E):
    """Columnar ``predict`` over a WorkloadTable (no collectives — matching
    the scalar default).  Bit-identical per row to scalar ``predict``."""
    from .workload import NV_FLOPS, NV_BYTES, NV_WS_OR_BYTES, NV_MATRIX, \
        NV_IRREGULAR, TableCols
    raw = table.cols
    flops, nbytes, wsb = raw[:, NV_FLOPS], raw[:, NV_BYTES], \
        raw[:, NV_WS_OR_BYTES]
    is_mat = raw[:, NV_MATRIX] != 0

    rate = table.per_precision_matrix(
        lambda p, m: hw.sustained_flops(p, matrix=m))
    eff = table.per_precision(
        lambda p: hw.precision_efficiency.get(p, 1.0))

    util = _mxu_utilization_batch(raw, eff)
    with np.errstate(divide="ignore", invalid="ignore"):
        t_comp = np.where(
            is_mat,
            flops / (rate * util / eff),
            np.where(flops > 0, flops / rate, 0.0))

    bw = working_set_blend_batch(wsb, hw)
    t_dma = hw.cycles_to_seconds(hw.tma_latency_cycles) + nbytes / bw
    t_dma = np.where(raw[:, NV_IRREGULAR] != 0, t_dma * 4.0, t_dma)

    alpha = hw.pipeline_overlap_alpha
    t_sync = hw.cycles_to_seconds(hw.mbarrier_latency_cycles)
    t_io_eff = (1.0 - alpha) * t_dma + t_sync                    # Eq. 7
    t_step = np.maximum(np.maximum(t_comp, t_io_eff), 0.0) + t_sync
    total = hw.launch_latency_s + t_step  # (N-1)*0.0 device term: no-op

    return TableCols(
        len(table),
        (total, t_comp, t_dma, t_io_eff, t_sync, hw.launch_latency_s,
         0.0, 0.0, 0.0),
        ("t_coll_exposed", "mxu_util", "alpha"),
        (0.0, np.where(is_mat, util, 0.0), alpha))


def predict_rows(ws: Sequence[Workload],
                 hw: HardwareParams = TPU_V5E) -> List[Row]:
    """Vectorized ``predict`` over a workload batch, in row form (no
    collectives — matching the scalar default)."""
    from .workload import WorkloadTable
    return predict_table_cols(WorkloadTable.from_workloads(ws), hw).rows()


def predict_batch(ws: Sequence[Workload],
                  hw: HardwareParams = TPU_V5E) -> List[TimeBreakdown]:
    """Materialized form of ``predict_rows``."""
    return [tb_from_row(r) for r in predict_rows(ws, hw)]


def straggler_budget(num_workers: int, hw: HardwareParams = TPU_V5E) -> float:
    """Paper's (N-1)*tau interference term repurposed as a per-step
    straggler/jitter budget across workers (DESIGN.md §3)."""
    return (max(num_workers, 1) - 1) * hw.tau_interference_s / max(
        num_workers, 1)


# ---------------------------------------------------------------------------
# Dry-run artifact consumption (the §Roofline deliverable).
# ---------------------------------------------------------------------------

# Task-spec hardware constants for the roofline terms.
PEAK_FLOPS_BF16 = 197e12          # per chip
HBM_BW = 819e9                    # per chip
ICI_LINK_BW = 50e9                # per link


@dataclass(frozen=True)
class RooflineReport:
    """Three-term roofline per (arch x shape x mesh) from a compiled
    dry-run artifact.  All terms in seconds (task-spec formulas)."""

    name: str
    num_chips: int
    hlo_flops: float              # whole-program FLOPs (all chips)
    hlo_bytes: float              # whole-program bytes accessed
    collective_bytes: float       # summed collective operand bytes
    model_flops: float            # 6*N*D (dense) / 6*N_active*D (MoE)

    @property
    def compute_term(self) -> float:
        return self.hlo_flops / (self.num_chips * PEAK_FLOPS_BF16)

    @property
    def memory_term(self) -> float:
        return self.hlo_bytes / (self.num_chips * HBM_BW)

    @property
    def collective_term(self) -> float:
        return self.collective_bytes / (self.num_chips * ICI_LINK_BW)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_term, "memory": self.memory_term,
                 "collective": self.collective_term}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.compute_term, self.memory_term, self.collective_term)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / HLO_FLOPs: fraction of compiled compute that is
        'useful' (catches remat/redundancy waste)."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """compute_term / bound_time: 1.0 == perfectly compute-bound at
        the spec roofline."""
        b = self.bound_time
        return self.compute_term / b if b > 0 else 0.0

    def row(self) -> Dict[str, float]:
        return {
            "chips": self.num_chips,
            "compute_s": self.compute_term,
            "memory_s": self.memory_term,
            "collective_s": self.collective_term,
            "dominant": self.dominant,
            "model_flops": self.model_flops,
            "hlo_flops": self.hlo_flops,
            "useful_ratio": self.useful_flops_ratio,
            "roofline_fraction": self.roofline_fraction,
        }


def report_from_artifacts(name: str, *, num_chips: int,
                          cost_analysis: Dict[str, float],
                          collective_bytes: float,
                          model_flops: float) -> RooflineReport:
    """Build a RooflineReport from compiled.cost_analysis() output + the
    HLO-parsed collective byte total (launch/hlo_analysis.py)."""
    flops = float(cost_analysis.get("flops", 0.0))
    nbytes = float(cost_analysis.get("bytes accessed", 0.0))
    return RooflineReport(name=name, num_chips=num_chips, hlo_flops=flops,
                          hlo_bytes=nbytes, collective_bytes=collective_bytes,
                          model_flops=model_flops)
