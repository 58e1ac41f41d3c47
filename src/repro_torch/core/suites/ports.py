"""H200 and MI250X port suites (paper Table VI rows 3-4, §V-B(e)).

The paper's portability claim: same model FRAMEWORK, parameter-file update
only, no re-derivation.  H200 gets the Blackwell stage model with Hopper
values (4.8 TB/s HBM, 141 GB, no TMEM/2-SM); MI250X gets the CDNA wavefront
model with its own values (3.2 TB/s, 128 MB LLC, 220 CUs).

Published anchors:
  * H200 microbench MAE 9.57% (n=21), roofline 94.5%
  * MI250X microbench MAE 4.69% (n=19), roofline 97.9%
  * MI250X FP64 GEMM at 16384^3: predicted 0.283 s vs measured 0.283 s
  * MI250X tile ordering reproduced (16x16 faster)
"""
from __future__ import annotations

from typing import List

from .. import predict as predict_mod
from ..hardware import H200, MI250X, HardwareParams
from ..workload import TileConfig, Workload, gemm_workload
from . import PROVENANCE_PAPER, PROVENANCE_RECON, SuiteEntry, \
    reconstruct_measured
from . import b200_microbench, mi300a_microbench

H200_MAE = 9.57
MI250X_MAE = 4.69
MI250X_DGEMM_MEASURED_S = 0.283


def h200_suite(hw: HardwareParams = H200) -> List[SuiteEntry]:
    """Same 21 kernel shapes as the B200 suite; H200 parameter file;
    measured values reconstructed at the published port error level."""
    entries: List[SuiteEntry] = []
    for w in b200_microbench.workloads():
        t_model = predict_mod.predict(w, hw).total
        meas = reconstruct_measured(f"{w.name}@h200", t_model, H200_MAE)
        entries.append(SuiteEntry(workload=w, measured_s=meas,
                                  provenance=PROVENANCE_RECON))
    return entries


def mi250x_workloads() -> List[Workload]:
    """19 kernels per §V-B(e): memory-bound vectors, FP64 GEMM, the
    occupancy/tile study (MI300A composition minus the stencil variants
    and two transposes)."""
    base = mi300a_microbench.workloads()
    keep = [w for w in base
            if not w.name.startswith("stencil_v")
            and w.name not in ("transpose_128", "transpose_192",
                               "dgemm_224")]
    # add the paper's large FP64 GEMM point
    keep.append(gemm_workload("dgemm_16384", 16384, 16384, 16384,
                              precision="fp64", tile=TileConfig(64, 64, 16)))
    assert len(keep) == 19, f"MI250X suite must have 19 kernels: {len(keep)}"
    return keep


def mi250x_suite(hw: HardwareParams = MI250X) -> List[SuiteEntry]:
    entries: List[SuiteEntry] = []
    for w in mi250x_workloads():
        if w.name == "dgemm_16384":
            entries.append(SuiteEntry(
                workload=w, measured_s=MI250X_DGEMM_MEASURED_S,
                provenance=PROVENANCE_PAPER,
                note="paper §V-B(e): 0.283 s predicted vs 0.283 s measured"))
            continue
        t_model = predict_mod.predict(w, hw).total
        meas = reconstruct_measured(f"{w.name}@mi250x", t_model, MI250X_MAE)
        entries.append(SuiteEntry(workload=w, measured_s=meas,
                                  provenance=PROVENANCE_RECON))
    return entries
