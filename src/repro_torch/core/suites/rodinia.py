"""Rodinia 3.1 segment files (paper §V-B/C, Table X, Fig. 4).

Each benchmark is a sum of segments (dominant GPU kernels / repeated launch
patterns) characterized by FLOPs, bytes, class and n_exec, with the paper's
documented segment-construction rules:

  * HotSpot (hs_calc): stencil class -> memory-bound transpose proxy.
  * Pathfinder (dynproc_kernel): reduced effective FLOPs/bytes per step.
  * SRAD: single aggregate, traffic sized from bytes column.
  * Backprop: two layers merged into ONE compute segment (avoids
    double-counting launch latency).
  * Streamcluster: n_exec scaled to the measured launch regime — the
    paper's flagship roofline failure: measured 157 ms on MI300A vs naive
    roofline 0.005 ms, because ~26k microsecond-scale launches dominate.

Measured totals: streamcluster_1M/MI300A is paper-published (157 ms); all
others are reconstructed from the paper's per-benchmark MAE (Table X).
"""
from __future__ import annotations

from typing import Dict, List

from .. import segments as seg_mod
from ..hardware import B200, MI300A, HardwareParams
from ..workload import Segment, Workload
from . import AppEntry, PROVENANCE_PAPER, PROVENANCE_RECON, \
    reconstruct_measured

# paper Table X: per-benchmark MAE (%) on B200 and MI300A
TABLE_X = {
    "hotspot_1024":     ("stencil",  31.0, 23.6),
    "hotspot_512":      ("stencil",  15.4, 1.6),
    "bfs_1M":           ("memory",   44.9, 40.9),
    "backprop_65536":   ("compute",  33.0, 21.3),
    "pathfinder_1000":  ("balanced",  0.4, 0.1),
    "srad_502":         ("balanced",  0.5, 0.5),
    "streamcluster_1M": ("memory",   12.4, 0.03),
}

STREAMCLUSTER_MEASURED_MI300A_S = 0.157     # paper §V-C
RODINIA_MAE_MI300A = 12.5                   # paper Obs. 2 overall


def _segments() -> Dict[str, List[Segment]]:
    MB = 1e6
    segs: Dict[str, List[Segment]] = {}

    # HotSpot: 5-point stencil over the grid, pyramid-blocked; routed as
    # memory-bound transpose proxy per the paper.
    for grid, iters in ((1024, 1000), (512, 1000)):
        traffic = 2.0 * grid * grid * 4.0
        segs[f"hotspot_{grid}"] = [Segment(
            workload=Workload(
                name=f"hs_calc_{grid}", wclass="stencil",
                flops=15.0 * grid * grid, bytes=traffic,
                precision="fp32", working_set_bytes=2 * grid * grid * 4.0),
            n_exec=iters)]

    # BFS: frontier expansion over 1M nodes, ~12 level iterations,
    # pointer-chasing (irregular=True -> Obs. 2 accuracy boundary).
    segs["bfs_1M"] = [Segment(
        workload=Workload(
            name="bfs_kernel", wclass="memory",
            flops=2.0e6, bytes=24.0 * MB, precision="fp32",
            working_set_bytes=40.0 * MB, irregular=True),
        n_exec=12)]

    # Backprop: layerforward + adjust_weights merged into ONE compute
    # segment (paper's rule).  Microsecond-scale: launch-dominated.
    n_in, n_hid = 65536, 16
    segs["backprop_65536"] = [Segment(
        workload=Workload(
            name="backprop_merged", wclass="compute",
            flops=2.0 * 2 * n_in * n_hid * 2,     # fwd+bwd, merged layers
            bytes=(n_in * n_hid * 4.0) * 3,
            precision="fp32", matrix=True,
            working_set_bytes=n_in * n_hid * 4.0),
        n_exec=2)]

    # Pathfinder: dynamic programming rows; reduced effective FLOPs/bytes
    # per step, effective timestep count aligned with profilers.
    cols, steps = 100000, 99
    segs["pathfinder_1000"] = [Segment(
        workload=Workload(
            name="dynproc_kernel", wclass="balanced",
            flops=6.0 * cols, bytes=8.0 * cols, precision="fp32",
            working_set_bytes=8.0 * cols),
        n_exec=steps)]

    # SRAD: single aggregate (N=M=0 in the paper's segment file); traffic
    # sized from the bytes column.
    g = 502
    segs["srad_502"] = [Segment(
        workload=Workload(
            name="srad_aggregate", wclass="balanced",
            flops=40.0 * g * g, bytes=10.0 * g * g * 4.0,
            precision="fp32", working_set_bytes=g * g * 4.0 * 2),
        n_exec=200)]

    # Streamcluster: ~26k tiny launches; each moves ~1 KB.  Model time is
    # n_exec * (launch + t_kernel) ~= 157 ms; naive roofline sees only the
    # ~26 MB of traffic -> ~5 us.
    segs["streamcluster_1M"] = [Segment(
        workload=Workload(
            name="pgain_kernel", wclass="memory",
            flops=256.0, bytes=1024.0, precision="fp32",
            working_set_bytes=1024.0),
        n_exec=26165)]
    return segs


def apps(platform: str = "mi300a") -> List[AppEntry]:
    """AppEntries for one platform ('b200' | 'mi300a')."""
    hw = MI300A if platform == "mi300a" else B200
    col = 2 if platform == "mi300a" else 1
    segs = _segments()
    out: List[AppEntry] = []
    for name, row in TABLE_X.items():
        wclass, mae = row[0], row[col]
        app_segs = tuple(segs[name])
        pred = seg_mod.predict_app(name, app_segs, hw).total
        if name == "streamcluster_1M" and platform == "mi300a":
            out.append(AppEntry(
                name=name, wclass=wclass, segments=app_segs,
                measured_s=STREAMCLUSTER_MEASURED_MI300A_S,
                provenance=PROVENANCE_PAPER, paper_mae_pct=mae,
                note="paper: measured 157 ms; roofline predicts 0.005 ms"))
            continue
        meas = reconstruct_measured(f"{name}@{platform}", pred, mae)
        out.append(AppEntry(name=name, wclass=wclass, segments=app_segs,
                            measured_s=meas, provenance=PROVENANCE_RECON,
                            paper_mae_pct=mae))
    return out
