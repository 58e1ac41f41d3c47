"""MI300A microbenchmark validation suite: 27 kernels (paper Table VI row 2,
§V-B(d)).

Composition per §V-B(d): "vectors, reductions, 2D transposes, FP64
rocblas_dgemm, occupancy-tile GEMMs, VGPR/cache stencil variants".

  * vectors (6): add/copy at 3 sizes
  * reductions (3)
  * 2D transposes (4): 2048^2..16384^2 — the paper applies host-measured
    multipliers for 8192^2 and 16384^2 (uncalibrated model is optimistic
    on large transpose traffic)
  * FP64 DGEMM (4): piecewise scaling vs M=N=K
  * occupancy-tile GEMMs (4): 8/16/32/64 tiles (Table VII row)
  * VGPR/cache stencil variants (6): VGPR 64/128/256 x resident/streaming

Uncalibrated error level ~6.5% (paper Obs. 1: "roughly 5-8% MAE");
per-case calibration brings it to ~0.09% (quantized multipliers leave a
small residual, mirroring the paper's nonzero calibrated MAE).
"""
from __future__ import annotations

from typing import List

from .. import cdna3, predict as predict_mod
from ..hardware import MI300A, HardwareParams
from ..workload import TileConfig, Workload, gemm_workload, \
    streaming_workload
from . import PROVENANCE_RECON, SuiteEntry, reconstruct_measured

TABLE_VI_MAE_CALIBRATED = 0.09
UNCALIBRATED_ERROR_LEVEL = 6.5    # Obs. 1: "roughly 5-8%"


def _vectors() -> List[Workload]:
    # us-scale parameter-extraction kernels (launch-overhead regime): this
    # is where naive roofline genuinely fails by ~99% (paper Table VI).
    KB = 1e3
    out = []
    for size, tag in ((64 * KB, "64KB"), (128 * KB, "128KB"),
                      (256 * KB, "256KB")):
        out.append(streaming_workload(f"vec_copy_{tag}", size))
        out.append(streaming_workload(f"vec_add_{tag}", size * 1.5,
                                      flops_per_byte=1.0 / 12.0))
    return out


def _reductions() -> List[Workload]:
    KB = 1e3
    return [streaming_workload(f"reduction_{tag}", size, flops_per_byte=0.25)
            for size, tag in ((64 * KB, "64KB"), (256 * KB, "256KB"),
                              (1024 * KB, "1MB"))]


def _transposes() -> List[Workload]:
    out = []
    for n in (128, 192, 256, 384):
        nb = 2.0 * n * n * 4
        out.append(streaming_workload(f"transpose_{n}", nb))
    return out


def _dgemms() -> List[Workload]:
    tile = TileConfig(64, 64, 16)
    return [gemm_workload(f"dgemm_{n}", n, n, n, precision="fp64", tile=tile)
            for n in (128, 160, 192, 224)]


def occupancy_tile_cases() -> List[Workload]:
    """GEMM at fixed problem size across tile sizes 8/16/32/64 (the
    occupancy/tile study; Eq. 14 must order 16x16 faster than 8x8)."""
    out = []
    for t in (8, 16, 32, 64):
        out.append(gemm_workload(f"occ_gemm_tile{t}", 256, 256, 256,
                                 precision="fp32",
                                 tile=TileConfig(t, t, 16)))
    return out


def _stencil_variants() -> List[Workload]:
    """VGPR-pressure x cache-residency stencil grid."""
    out = []
    for vgpr in (64, 128, 256):
        for resident, tag in ((True, "resident"), (False, "streaming")):
            g = 256 if resident else 768      # LLC-resident vs larger grid
            out.append(Workload(
                name=f"stencil_v{vgpr}_{tag}", wclass="stencil",
                flops=7.0 * g * g, bytes=8.0 * g * g, precision="fp32",
                working_set_bytes=8.0 * g * g,
                vgpr_per_workitem=vgpr,
            ))
    return out


def workloads() -> List[Workload]:
    ws = (_vectors() + _reductions() + _transposes() + _dgemms()
          + occupancy_tile_cases() + _stencil_variants())
    assert len(ws) == 27, f"MI300A suite must have 27 kernels, got {len(ws)}"
    return ws


def suite(hw: HardwareParams = MI300A) -> List[SuiteEntry]:
    entries: List[SuiteEntry] = []
    for w in workloads():
        t_model = predict_mod.predict(w, hw).total
        meas = reconstruct_measured(w.name, t_model,
                                    UNCALIBRATED_ERROR_LEVEL)
        note = ""
        if w.name in ("transpose_8192", "transpose_16384"):
            note = "paper applies host-measured multiplier (large transpose)"
        elif w.name.startswith("dgemm"):
            note = "paper: piecewise scaling vs M=N=K"
        entries.append(SuiteEntry(workload=w, measured_s=meas,
                                  provenance=PROVENANCE_RECON, note=note))
    return entries
