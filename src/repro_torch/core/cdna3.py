"""Wavefront-centric analytical model for AMD CDNA3 / MI300A (paper §IV-B).

Overlap is implicit and occupancy-driven; accumulators live in VGPRs:

    eta_overlap = min(1, (N_wf_active - 1) * T_compute / T_memory)   (Eq. 9)
    T_memory^eff: expected-latency walk over L1/L2/LLC/HBM           (Eq. 10)
    BW_eff = h_LLC * BW_LLC + (1 - h_LLC) * BW_HBM
    h_LLC(W): piecewise Infinity-Cache model                         (Tab. III)
    T_compute^MFMA = N_inst / (N_CU * Thr_MFMA * Util)               (Eq. 11)
    N_wf_active = min(32, floor(65536 / VGPR_per_wf))
    T_step = (T_memory^eff + T_compute) / (1 + eta_overlap)          (Eq. 12)
    T_kernel = T_launch + K_tiles*T_step + T_writeback
               + T_coherence + T_crossXCD                            (Eq. 13)
    occupancy/tile pipeline model                                    (Eq. 14)

Optional extensions implemented per §IV-B: MWP/CWP limits, multi-kernel
interference (N-1)*tau_interf, multi-GPU (N-1)*tau_gpu, adaptive tile
selection, kernel fusion with tau_fusion.
"""
from __future__ import annotations

import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np


from .cache import effective_bandwidth_llc, effective_bandwidth_llc_batch, \
    hierarchy_latency_walk, llc_hit_rate, llc_hit_rate_batch
from .hardware import BYTES_PER_ELEM, HardwareParams
from .workload import GemmShape, Row, TileConfig, TimeBreakdown, Workload, \
    row_from_tb, tb_from_row

MFMA_FLOPS_PER_INST = 512.0  # 32x32x8 fp64 MFMA ~= 2*32*32*8/128... canonical
                             # per-inst FLOP count used to convert FLOPs ->
                             # instruction counts (paper Eq. 11 N_MFMA_inst).


def vgpr_limited_occupancy(vgpr_per_workitem: int, hw: HardwareParams,
                           *, mwp: int = 0, cwp: int = 0) -> int:
    """N_wf_active = min(32, floor(65536 / VGPR_per_wf)); optionally capped
    by MWP/CWP limits (paper §IV-B: N_wf_eff = min(N_active, MWP, CWP))."""
    # VGPR_per_wf = per-workitem VGPRs x wavefront width; the 65536 budget
    # is the CU's VGPR file in workitem-register units (paper's formula).
    vgpr_per_wf = max(1, vgpr_per_workitem) * hw.warp_size
    n = min(hw.max_resident_warps, hw.vgpr_per_cu // max(vgpr_per_wf, 1))
    n = max(1, n)
    if mwp > 0:
        n = min(n, mwp)
    if cwp > 0:
        n = min(n, cwp)
    return int(n)


def overlap_factor(n_wf_active: int, t_compute: float,
                   t_memory: float) -> float:
    """Eq. 9. Returns eta in [0, 1]."""
    if t_memory <= 0:
        return 1.0
    eta = (max(n_wf_active, 1) - 1) * t_compute / t_memory
    return min(1.0, max(0.0, eta))


def memory_time(w: Workload, hw: HardwareParams) -> float:
    """T_memory^eff: Eq. 10 latency walk when per-load hit rates and
    N_loads are given, else bandwidth path bytes / BW_eff with h_LLC(W)."""
    if w.num_loads > 0 and w.hit_rates:
        return hierarchy_latency_walk(w.num_loads, w.hit_rates, hw)
    h = w.hit_rates.get("llc") if w.hit_rates else None
    bw = effective_bandwidth_llc(w.working_set_bytes or w.bytes, hw, h_llc=h)
    t = w.bytes / bw
    if w.irregular:
        t *= 4.0  # Obs. 2: irregular access degrades toward latency-bound
    return t


def mfma_compute_time(w: Workload, hw: HardwareParams) -> float:
    """Eq. 11: T = N_inst / (N_CU * Throughput_MFMA * Utilization).

    We convert FLOPs -> MFMA instructions and use the measured per-chip
    matrix throughput, so the equation reduces to
    flops / (chip_matrix_flops * utilization); the N_CU factorization is
    kept in the parameter file (throughput is per chip = per CU * N_CU).
    """
    eff = hw.precision_efficiency.get(w.precision, 1.0)
    if w.precision in hw.tensor_sustained_flops:
        # sustained throughput *is* peak*utilization as measured; applying
        # Util again would double-count.
        rate = hw.tensor_sustained_flops[w.precision] * eff
    else:
        # Eq. 11 literal form: peak * Utilization (Util 0.4-0.7, Table IV)
        rate = hw.peak_flops(w.precision, matrix=True) \
            * hw.mfma_utilization * eff
    return w.flops / rate


def vector_compute_time(w: Workload, hw: HardwareParams) -> float:
    rate = hw.sustained_flops(w.precision, matrix=False)
    return w.flops / rate if w.flops > 0 else 0.0


def step_time(t_memory: float, t_compute: float, eta: float) -> float:
    """Eq. 12: T_step = (T_mem + T_comp) / (1 + eta)."""
    return (t_memory + t_compute) / (1.0 + eta)


def predict(w: Workload, hw: HardwareParams, *,
            mwp: int = 0, cwp: int = 0,
            k_tiles_override: Optional[int] = None) -> TimeBreakdown:
    """Wavefront-centric MI300A prediction (Eq. 9-13).

    The base model (MWP=CWP=0) is what the paper's reported MAE uses.
    """
    if hw.model_family != "cdna":
        raise ValueError(f"cdna3 model mis-routed to {hw.name}")

    n_wf = vgpr_limited_occupancy(w.vgpr_per_workitem, hw, mwp=mwp, cwp=cwp)
    k_tiles = k_tiles_override if k_tiles_override is not None \
        else max(w.k_tiles, 1)

    # per-step slices of the kernel's totals
    t_mem_total = memory_time(w, hw)
    t_comp_total = (mfma_compute_time(w, hw) if w.matrix
                    else vector_compute_time(w, hw))
    t_mem = t_mem_total / k_tiles
    t_comp = t_comp_total / k_tiles

    eta = overlap_factor(n_wf, t_comp, t_mem)
    t_step = step_time(t_mem, t_comp, eta)

    t_writeback = 0.0
    if w.gemm is not None:
        out_b = w.gemm.m * w.gemm.n * BYTES_PER_ELEM[w.precision]
        t_writeback = out_b / effective_bandwidth_llc(
            w.working_set_bytes or w.bytes, hw)

    total = (hw.launch_latency_s + k_tiles * t_step + t_writeback
             + hw.coherence_latency_s + hw.cross_xcd_latency_s)   # Eq. 13
    # §IV-B multi-kernel / multi-GPU interference terms
    total += (w.concurrent_kernels - 1) * hw.tau_interference_s
    total += (w.num_devices - 1) * hw.tau_interference_gpu_s

    return TimeBreakdown(
        total=total,
        compute=t_comp_total,
        memory=t_mem_total,
        io_effective=t_mem_total,
        sync=hw.coherence_latency_s + hw.cross_xcd_latency_s,
        launch=hw.launch_latency_s,
        writeback=t_writeback,
        detail={
            "n_wf_active": float(n_wf), "eta_overlap": eta,
            "t_step": t_step,
            "h_llc": llc_hit_rate(w.working_set_bytes or w.bytes, hw),
        },
    )


# ---------------------------------------------------------------------------
# Columnar (NumPy-vectorized) wavefront model — the WorkloadTable /
# SweepEngine hot path.  Workloads carrying explicit hit rates or an Eq. 10
# latency walk (per-workload dicts) fall back to the scalar `predict`;
# everything else is vectorized bit-identically to the scalar expressions.
# ---------------------------------------------------------------------------

def _rate_fn(hw: HardwareParams):
    """Compute rate per (precision, matrix) mirroring mfma_compute_time /
    vector_compute_time rate selection."""
    def fn(p: str, matrix: bool) -> float:
        if matrix:
            eff = hw.precision_efficiency.get(p, 1.0)
            if p in hw.tensor_sustained_flops:
                return hw.tensor_sustained_flops[p] * eff
            return hw.peak_flops(p, matrix=True) * hw.mfma_utilization * eff
        return hw.sustained_flops(p, matrix=False)
    return fn


def _vectorized_cols(table, hw: HardwareParams):
    from .workload import NV_VGPR, NV_K_TILES, NV_BYTES, NV_WS_OR_BYTES, \
        NV_FLOPS, NV_IRREGULAR, NV_GMN, NV_HAS_GEMM, NV_MATRIX, \
        NV_CONCURRENT, NV_DEVICES, TableCols
    raw = table.cols
    vgpr_wf = np.maximum(1, raw[:, NV_VGPR].astype(np.int64)) * hw.warp_size
    n_wf = np.maximum(
        1, np.minimum(hw.max_resident_warps, hw.vgpr_per_cu // vgpr_wf))
    k_tiles = np.maximum(raw[:, NV_K_TILES].astype(np.int64), 1)

    nbytes, wsb, flops = raw[:, NV_BYTES], raw[:, NV_WS_OR_BYTES], \
        raw[:, NV_FLOPS]
    bw_eff = effective_bandwidth_llc_batch(wsb, hw)
    t_mem_total = nbytes / bw_eff
    t_mem_total = np.where(raw[:, NV_IRREGULAR] != 0, t_mem_total * 4.0,
                           t_mem_total)
    rate = table.per_precision_matrix(_rate_fn(hw))
    with np.errstate(divide="ignore", invalid="ignore"):
        t_comp_total = np.where((raw[:, NV_MATRIX] != 0) | (flops > 0),
                                flops / rate, 0.0)

    t_mem = t_mem_total / k_tiles
    t_comp = t_comp_total / k_tiles
    with np.errstate(divide="ignore", invalid="ignore"):
        eta_raw = (n_wf - 1) * t_comp / t_mem
        eta = np.where(t_mem <= 0, 1.0,
                       np.minimum(1.0, np.maximum(0.0, eta_raw)))
    t_step = (t_mem + t_comp) / (1.0 + eta)

    if raw[:, NV_HAS_GEMM].any():
        in_b = table.per_precision(lambda p: BYTES_PER_ELEM[p])
        out_b = raw[:, NV_GMN] * in_b
        t_writeback = np.where(raw[:, NV_HAS_GEMM] != 0,
                               out_b / bw_eff, 0.0)
    else:
        t_writeback = np.zeros(len(table))

    total = hw.launch_latency_s + k_tiles * t_step + t_writeback \
        + hw.coherence_latency_s + hw.cross_xcd_latency_s          # Eq. 13
    total = total + (raw[:, NV_CONCURRENT] - 1) * hw.tau_interference_s
    total = total + (raw[:, NV_DEVICES] - 1) * hw.tau_interference_gpu_s

    h_llc = llc_hit_rate_batch(wsb, hw)
    sync = hw.coherence_latency_s + hw.cross_xcd_latency_s
    return TableCols(
        len(table),
        (total, t_comp_total, t_mem_total, t_mem_total, sync,
         hw.launch_latency_s, t_writeback, 0.0, 0.0),
        ("n_wf_active", "eta_overlap", "t_step", "h_llc"),
        (n_wf.astype(np.float64), eta, t_step, h_llc))


def predict_table_cols(table, hw: HardwareParams):
    """Columnar ``predict`` over a WorkloadTable (base model, MWP=CWP=0).
    Bit-identical per row to scalar ``predict``; rows with explicit hit
    rates / Eq. 10 latency walks fall back to the scalar path per row."""
    from .workload import NV_NUM_LOADS, RowsCols, SegmentedCols
    if hw.model_family != "cdna":
        raise ValueError(f"cdna3 model mis-routed to {hw.name}")
    exotic = table.cols[:, NV_NUM_LOADS] > 0
    if table.hit_rates is not None:
        exotic = exotic | np.array([bool(h) for h in table.hit_rates])
    if not exotic.any():
        return _vectorized_cols(table, hw)
    idx_e = np.flatnonzero(exotic)
    idx_f = np.flatnonzero(~exotic)
    segments = [(idx_e, RowsCols(
        # repro: allow[SWEEP-LOOP] exotic rows (explicit hit rates /
        # Eq. 10 latency walks) are priced per row by design — the
        # columnar kernel has no path for them and bit-identity with
        # scalar predict() is the contract tests pin
        [row_from_tb(predict(table.workload(int(i)), hw))
         for i in idx_e]))]
    if len(idx_f):
        segments.append((idx_f, _vectorized_cols(table.take(idx_f), hw)))
    return SegmentedCols(len(table), segments)


def predict_rows(ws: Sequence[Workload], hw: HardwareParams) -> List[Row]:
    """Vectorized ``predict`` over a workload batch, in row form (base
    model, MWP=CWP=0).  Bit-identical to per-workload ``predict``;
    workloads with explicit hit rates / Eq. 10 latency walks fall back to
    the scalar path."""
    from .workload import WorkloadTable
    return predict_table_cols(WorkloadTable.from_workloads(ws), hw).rows()


def predict_batch(ws: Sequence[Workload],
                  hw: HardwareParams) -> List[TimeBreakdown]:
    """Materialized form of ``predict_rows``."""
    return [tb_from_row(r) for r in predict_rows(ws, hw)]


# ---------------------------------------------------------------------------
# Occupancy/tile pipeline model (Eq. 14): used for the 8x8 vs 16x16 study.
# ---------------------------------------------------------------------------

def occupancy_tile_predict(w: Workload, hw: HardwareParams, *,
                           tau_cta_s: float = 2e-7,
                           w_eff: Optional[float] = None) -> TimeBreakdown:
    """Eq. 14:
    T = T_launch + tau_cta*N_ctas + N_ctas*T_step_cta/(N_CU*W_eff)
        + T_writeback + T_coherence + T_crossXCD
    with T_step_cta = max(flops_per_cta/peak_cta, bytes_per_cta/BW_eff).
    """
    tile = w.tile or TileConfig()
    n_ctas = max(w.num_ctas, 1)
    flops_per_cta = w.flops / n_ctas
    bytes_per_cta = (w.bytes_per_cta * max(w.k_tiles, 1)
                     if w.bytes_per_cta > 0 else w.bytes / n_ctas)

    if w_eff is None:
        # effective wavefronts per CU: larger tiles need more VGPRs
        # (accumulator bM*bN/wavefront) -> lower occupancy, better reuse.
        accum_vgprs = tile.bm * tile.bn / hw.warp_size / 4  # 4B regs, /64 lanes
        vgpr_wi = max(32, int(accum_vgprs))
        w_eff = float(vgpr_limited_occupancy(vgpr_wi, hw))

    bw_eff = effective_bandwidth_llc(w.working_set_bytes or w.bytes, hw)
    peak_cta = (hw.sustained_flops(w.precision, matrix=w.matrix)
                / hw.num_sms)
    t_step_cta = max(flops_per_cta / peak_cta, bytes_per_cta / bw_eff)

    t_sched = tau_cta_s * n_ctas
    t_exec = n_ctas * t_step_cta / (hw.num_sms * max(w_eff, 1.0))
    out_b = (w.gemm.m * w.gemm.n * BYTES_PER_ELEM[w.precision]
             if w.gemm else 0.0)
    t_writeback = out_b / bw_eff
    total = (hw.launch_latency_s + t_sched + t_exec + t_writeback
             + hw.coherence_latency_s + hw.cross_xcd_latency_s)
    return TimeBreakdown(
        total=total, compute=n_ctas * flops_per_cta / peak_cta / hw.num_sms,
        memory=n_ctas * bytes_per_cta / bw_eff / hw.num_sms,
        launch=hw.launch_latency_s + t_sched, writeback=t_writeback,
        detail={"w_eff": w_eff, "t_step_cta": t_step_cta,
                "n_ctas": float(n_ctas)},
    )


def adaptive_tile_selection(
        base: Workload, hw: HardwareParams,
        candidate_tiles: Iterable[TileConfig],
        **kw) -> Tuple[TileConfig, Dict[str, float]]:
    """Paper §IV-B 'adaptive tile selection': evaluate candidate tiles via
    the model and return the minimum-time tile (+ the full cost map)."""
    costs: Dict[str, float] = {}
    best: Optional[TileConfig] = None
    best_t = math.inf
    for tile in candidate_tiles:
        w = _retile(base, tile)
        t = occupancy_tile_predict(w, hw, **kw).total
        costs[f"{tile.bm}x{tile.bn}x{tile.bk}"] = t
        if t < best_t:
            best_t, best = t, tile
    assert best is not None, "no candidate tiles given"
    return best, costs


def _retile(w: Workload, tile: TileConfig) -> Workload:
    if w.gemm is None:
        return w.replace(tile=tile)
    g = w.gemm
    num_ctas = -(-g.m // tile.bm) * -(-g.n // tile.bn)
    k_tiles = -(-g.k // tile.bk)
    in_b = BYTES_PER_ELEM[w.precision]
    bytes_per_cta = (tile.bm * tile.bk + tile.bk * tile.bn) * in_b
    return w.replace(tile=tile, num_ctas=num_ctas, k_tiles=k_tiles,
                     bytes_per_cta=bytes_per_cta)


def fused_predict(parts: List[Workload], hw: HardwareParams) -> TimeBreakdown:
    """Paper §IV-B kernel fusion: combined FLOPs/bytes + tau_fusion,
    minus the intermediate writeback/read traffic between the parts."""
    if not parts:
        raise ValueError("fusion of zero kernels")
    combined_flops = sum(p.flops for p in parts)
    # fusing removes the intermediate tensor round-trip between stages
    inter_bytes = sum(min(parts[i].bytes, parts[i + 1].bytes) * 0.5
                      for i in range(len(parts) - 1))
    combined_bytes = max(sum(p.bytes for p in parts) - inter_bytes, 0.0)
    fused = parts[0].replace(
        name="+".join(p.name for p in parts),
        flops=combined_flops, bytes=combined_bytes,
        working_set_bytes=max(p.working_set_bytes for p in parts),
    )
    out = predict(fused, hw)
    return TimeBreakdown(
        total=out.total + hw.tau_fusion_s,
        compute=out.compute, memory=out.memory,
        io_effective=out.io_effective, sync=out.sync, launch=out.launch,
        writeback=out.writeback,
        detail=dict(out.detail, tau_fusion=hw.tau_fusion_s),
    )
