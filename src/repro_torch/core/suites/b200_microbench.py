"""B200 microbenchmark validation suite: 21 kernels (paper Table VI row 1,
Table IX classes, §V-B(c) narrative).

Classes and counts mirror the paper:
  * memory-bound (8): vector add/copy (2 sizes), transpose (2 sizes),
    reduction (2 sizes) — class error ~8.4% driven by L2 benefits and
    5-12us launch overhead on the small sizes.
  * compute-bound (7): FP16/FP8/LLM GEMMs via cuBLAS — class error ~5.4%.
  * balanced (6): FFT, SpMV (two densities), GEMV, stencils — ~7.9%;
    spmv at 0.1% density is the 13.6%-error outlier (atomics/load balance
    not modeled -> flagged irregular).

Suite-level reconstruction targets Table VI: model MAE 1.33%.
The headline Table VI number uses per-kernel error levels ~1.33%; the
per-class §V-B(c) narrative numbers are exposed via ``class_error_levels``
for the observation benchmark.
"""
from __future__ import annotations

from typing import List

from .. import blackwell, predict as predict_mod
from ..hardware import B200, HardwareParams
from ..workload import TileConfig, Workload, gemm_workload, streaming_workload
from . import PROVENANCE_PAPER, PROVENANCE_RECON, SuiteEntry, \
    reconstruct_measured

TABLE_VI_MAE = 1.33          # paper Table VI, B200 row
CLASS_ERROR_LEVELS = {"memory": 8.4, "compute": 5.4, "balanced": 7.9}

# The paper's worked example (§IV-D): GEMM M=N=K=16384, tile 128x128x32,
# predicted 4.17 ms vs measured 4.10 ms (1.8% error).  FP8 LLM GEMM class.
PAPER_GEMM_PREDICTED_MS = 4.17
PAPER_GEMM_MEASURED_MS = 4.10


def _w_memory() -> List[Workload]:
    # Microbenchmark regime: parameter-extraction kernels are us-scale, so
    # the 5-12us launch overhead + sustained-vs-peak gap compound — exactly
    # the paper's §II explanation of why naive roofline exceeds 95% error.
    MB = 1e6
    out = []
    for size, tag in ((0.5 * MB, "512KB"), (2.0 * MB, "2MB")):
        out.append(streaming_workload(f"vec_copy_{tag}", size,
                                      flops_per_byte=0.0))
        out.append(streaming_workload(f"vec_add_{tag}", size * 1.5,
                                      flops_per_byte=1.0 / 12.0))
        out.append(streaming_workload(f"reduction_{tag}", size,
                                      flops_per_byte=0.25))
    for n in (256, 512):
        nb = 2.0 * n * n * 4
        out.append(streaming_workload(f"transpose_{n}", nb))
    return out


def _w_compute() -> List[Workload]:
    tile = TileConfig(128, 128, 32)
    out = []
    for n in (512, 768, 1024):
        out.append(gemm_workload(f"gemm_fp16_{n}", n, n, n,
                                 precision="fp16", tile=tile))
    for n in (1024, 1280):
        out.append(gemm_workload(f"gemm_fp8_{n}", n, n, n,
                                 precision="fp8", tile=tile))
    # LLM-shaped projection GEMM (decode-time skinny GEMM)
    out.append(gemm_workload("llm_gemm_qkv", 1024, 1280, 1024,
                             precision="fp8", tile=tile))
    # the paper's worked example: the one LARGE kernel in the suite
    out.append(gemm_workload("gemm_fp8_16384", 16384, 16384, 16384,
                             precision="fp8", tile=tile))
    return out


def _w_balanced() -> List[Workload]:
    out = []
    n_fft = 1 << 16
    out.append(Workload(
        name="fft_64K", wclass="balanced",
        flops=5.0 * n_fft * 16,          # 5 N log2 N
        bytes=16.0 * n_fft * 3,          # multi-pass complex traffic
        precision="fp32", working_set_bytes=16.0 * n_fft,
    ))
    for n, dens, tag, irr in ((8192, 0.001, "0.1pct", True),
                              (4096, 0.01, "1pct", False)):
        nnz = n * n * dens
        out.append(Workload(
            name=f"spmv_{tag}", wclass="balanced",
            flops=2.0 * nnz, bytes=nnz * 12.0 + n * 8.0,
            precision="fp32", working_set_bytes=nnz * 12.0,
            irregular=irr, atomics=irr,
        ))
    out.append(Workload(
        name="gemv_1024", wclass="balanced",
        flops=2.0 * 1024.0 ** 2, bytes=4.0 * (1024.0 ** 2 + 2 * 1024),
        precision="fp32", working_set_bytes=4.0 * 1024.0 ** 2,
    ))
    for g in (256, 512):
        out.append(Workload(
            name=f"stencil_{g}", wclass="stencil",
            flops=7.0 * g * g, bytes=8.0 * g * g,
            precision="fp32", working_set_bytes=8.0 * g * g,
        ))
    return out


def workloads() -> List[Workload]:
    ws = _w_memory() + _w_compute() + _w_balanced()
    assert len(ws) == 21, f"B200 suite must have 21 kernels, got {len(ws)}"
    return ws


def suite(hw: HardwareParams = B200) -> List[SuiteEntry]:
    """21 entries with measured values (reconstruction per suites/__init__)."""
    entries: List[SuiteEntry] = []
    for w in workloads():
        t_model = predict_mod.predict(w, hw).total
        if w.name == "gemm_fp8_16384":
            # paper-published absolute measurement (§IV-D example)
            entries.append(SuiteEntry(
                workload=w, measured_s=PAPER_GEMM_MEASURED_MS * 1e-3,
                provenance=PROVENANCE_PAPER,
                note="paper §IV-D: predicted 4.17ms vs measured 4.10ms"))
            continue
        meas = reconstruct_measured(w.name, t_model, TABLE_VI_MAE)
        entries.append(SuiteEntry(workload=w, measured_s=meas,
                                  provenance=PROVENANCE_RECON))
    return entries


def two_sm_case() -> Workload:
    """The 2-SM cooperative validation case (§V-B(c))."""
    return gemm_workload("gemm_fp8_2sm", 16384, 16384, 16384,
                         precision="fp8", tile=TileConfig(128, 128, 32))
