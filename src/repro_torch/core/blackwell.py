"""Stage-centric analytical model for NVIDIA Blackwell (paper §IV-A).

Execution time is assembled from explicitly measurable pipeline stages
(TMA -> TMEM -> TensorCore -> Sync), per paper Fig. 3:

    T_step   = max(T_compute, T_io_eff) + T_sync + O_misc          (Eq. 8)
    T_kernel = T_launch + waves * K_tiles * T_step + T_writeback

with
    T_compute       = 2 bM bN bK / (R_TC^SM * S_mode)
                      + T_TMEM + T_TMEM_mgmt                        (Eq. 3/6)
    T_TMEM_per_tile = D_accum/BW_read + L_mma + D_accum/BW_write    (Eq. 2)
    T_tma           = L_TMA + bytes(T) / (P * B_TMA)                (Eq. 4)
    T_DE_load       = D_unc / (CR * BW_link * eta_DE)               (Eq. 5)
    T_io_eff        = (1-alpha)(T_tma + T_decomp) + T_sync          (Eq. 7)
    T_sync          = N_bar * L_mbar

Interpretive choices (the paper's prose is the spec; these are documented
deviations/disambiguations):
  * Eq. 2's accumulator traffic is paid once per OUTPUT TILE (accumulators
    stay TMEM-resident across K-steps) and amortized over K_tiles, matching
    the text "TMEM (256 KB/SM) holds accumulators" and the measured 22 TB/s
    epilogue bandwidth note in §V-B.
  * B_TMA is a chip-level effective bandwidth; each concurrently resident
    CTA gets an equal share (persistent-kernel execution, one CTA/SM).
  * Exceeding TMEM capacity (bM*bN*4B > 256 KB) forces spill: modeled as a
    2x penalty on the TMEM term plus per-step (not amortized) payment.
  * Non-GEMM workloads route through the memory/vector stage directly
    (the paper routes them to the generic path; ``predict`` handles both so
    the stage model is total).
"""
from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np


from .cache import working_set_blend, working_set_blend_batch
from .hardware import BYTES_PER_ELEM, HardwareParams
from .workload import Row, TimeBreakdown, TileConfig, Workload, tb_from_row

ACCUM_BYTES = 4.0  # FP32 accumulators in TMEM


def tmem_time_per_tile(tile: TileConfig, hw: HardwareParams) -> float:
    """Eq. 2: T_TMEM = D/BW_read + L_mma + D/BW_write, per output tile.

    Bandwidths in the parameter file are chip-level; an SM's share is
    BW/num_sms (one resident CTA per SM in persistent kernels).
    """
    d_accum = tile.accum_bytes(ACCUM_BYTES)
    bw_r = hw.accum_read_bw / hw.num_sms
    bw_w = hw.accum_write_bw / hw.num_sms
    t = d_accum / bw_r + hw.cycles_to_seconds(hw.mma_latency_cycles) \
        + d_accum / bw_w
    if d_accum > hw.accum_capacity_bytes:
        t *= 2.0  # spill penalty: "Exceeding 256 KB forces spill"
    return t


def tmem_mgmt_amortized(k_tiles: int, hw: HardwareParams) -> float:
    """T_TMEM_mgmt = (L_alloc + L_dealloc) / K_tiles (paper §IV-A5)."""
    return hw.tmem_alloc_latency_s / max(k_tiles, 1)


def compute_time_per_step(w: Workload, hw: HardwareParams, *,
                          two_sm: bool = False,
                          sustained: bool = True) -> float:
    """Eq. 3 / Eq. 6: per-K-step tensor-core compute time."""
    tile = w.tile or TileConfig()
    flops = tile.flops_per_tile_step
    rate = (hw.sustained_flops(w.precision, matrix=True) if sustained
            else hw.peak_flops(w.precision, matrix=True))
    r_sm = rate / hw.num_sms
    s_mode = hw.two_sm_speedup if two_sm else 1.0
    eff = hw.precision_efficiency.get(w.precision, 1.0)
    t_mma = flops / (r_sm * s_mode * eff)
    k_tiles = max(w.k_tiles, 1)
    spill = tile.accum_bytes(ACCUM_BYTES) > hw.accum_capacity_bytes
    t_tmem_tile = tmem_time_per_tile(tile, hw)
    # resident accumulators amortize; spilled ones pay per step
    t_tmem = t_tmem_tile if spill else t_tmem_tile / k_tiles
    return t_mma + t_tmem + tmem_mgmt_amortized(k_tiles, hw)


def tma_time_per_step(w: Workload, hw: HardwareParams, *,
                      two_sm: bool = False) -> float:
    """Eq. 4: T_tma = L_TMA + bytes / (P * B_TMA-per-CTA-share).

    2-SM CTA pairs share the B operand via DSMEM: traffic 2M_A + M_B
    instead of 2(M_A + M_B) (paper §IV-A4, ~1.33x reduction for square
    tiles).
    """
    tile = w.tile or TileConfig()
    in_b = BYTES_PER_ELEM[w.precision]
    m_a = tile.bm * tile.bk * in_b
    m_b = tile.bk * tile.bn * in_b
    if two_sm:
        bytes_step = (2 * m_a + m_b) / 2.0  # per CTA of the pair
    else:
        bytes_step = m_a + m_b
    if w.bytes_per_cta > 0 and not two_sm:
        bytes_step = w.bytes_per_cta
    active_ctas = max(1, min(w.num_ctas or hw.num_sms, hw.num_sms))
    # L2-residency-aware effective TMA bandwidth (Eq. 16 blend; §IV-A2
    # "L2 hit rates strongly affect B_TMA")
    b_tma = working_set_blend(
        w.working_set_bytes, hw,
        peak=hw.tma_bandwidth * 1.35, sustained=hw.tma_bandwidth)
    per_cta_bw = b_tma / active_ctas
    p = max(1, w.tma_participants)
    return hw.cycles_to_seconds(hw.tma_latency_cycles) \
        + bytes_step / (p * per_cta_bw)


def decompression_time(w: Workload, hw: HardwareParams) -> float:
    """Eq. 5: T_DE_load = D_unc / (CR * BW_link * eta_DE)."""
    if w.compressed_bytes <= 0:
        return 0.0
    d_unc = w.compressed_bytes * w.compression_ratio
    link = max(
        min(hw.hbm_sustained_bw, hw.decomp_engine_rate or math.inf), 1.0)
    return d_unc / (w.compression_ratio * link * hw.decomp_efficiency)


def sync_time(hw: HardwareParams, n_bar: int = 1) -> float:
    """T_sync = N_bar * L_mbar (N_bar typically 1-2)."""
    return n_bar * hw.cycles_to_seconds(hw.mbarrier_latency_cycles)


def _tiled_gemm_predict(w: Workload, hw: HardwareParams, *,
                        two_sm: bool, n_bar: int) -> TimeBreakdown:
    k_tiles = max(w.k_tiles, 1)
    t_comp = compute_time_per_step(w, hw, two_sm=two_sm)
    t_tma = tma_time_per_step(w, hw, two_sm=two_sm)
    t_dec = decompression_time(w, hw) / max(w.num_ctas * k_tiles, 1)
    t_sync = sync_time(hw, n_bar)
    alpha = hw.pipeline_overlap_alpha
    t_io_eff = (1.0 - alpha) * (t_tma + t_dec) + t_sync          # Eq. 7
    # O_misc: TMEM mgmt is already inside T_compute (Eq. 3); adding it again
    # here would double-count (paper lists it in both Eq. 3 and Eq. 8 —
    # disambiguated to Eq. 3 only).
    o_misc = 0.0
    t_step = max(t_comp, t_io_eff) + t_sync + o_misc             # Eq. 8

    num_ctas = max(w.num_ctas, 1)
    if two_sm:
        num_ctas = max(1, num_ctas)  # pairs co-scheduled on adjacent SMs
    # fractional waves: persistent-kernel execution keeps all SMs busy until
    # the tail; grids smaller than the SM count still occupy one wave.
    waves = max(1.0, num_ctas / hw.num_sms)
    # first wave pays the un-overlapped TMA prologue (pipeline fill)
    t_fill = t_tma + t_dec
    t_body = waves * k_tiles * t_step

    # writeback: C tile via TMA store, overlapped in persistent kernels
    out_bytes = 0.0
    if w.gemm is not None:
        out_bytes = w.gemm.m * w.gemm.n * BYTES_PER_ELEM[w.precision]
    t_store = (1.0 - alpha) * out_bytes / hw.hbm_sustained_bw

    total = hw.launch_latency_s + t_fill + t_body + t_store
    total += (w.concurrent_kernels - 1) * hw.tau_interference_s   # §IV-A6
    total += (w.num_devices - 1) * hw.tau_interference_gpu_s
    return TimeBreakdown(
        total=total,
        compute=waves * k_tiles * t_comp,
        memory=waves * k_tiles * t_tma,
        io_effective=waves * k_tiles * t_io_eff,
        sync=waves * k_tiles * t_sync,
        launch=hw.launch_latency_s,
        writeback=t_store,
        detail={
            "t_step": t_step, "t_compute_step": t_comp,
            "t_tma_step": t_tma, "t_sync_step": t_sync,
            "waves": waves, "k_tiles": float(k_tiles),
            "pipeline_fill": t_fill,
        },
    )


def _streaming_predict(w: Workload, hw: HardwareParams) -> TimeBreakdown:
    """Memory/balanced/stencil kernels: sustained-bandwidth stage with the
    Eq. 16 working-set blend, vector-path compute, launch overhead.

    This is the Blackwell instantiation of the paper's generic path
    (§IV-F); vector ops land within 7-9% per §V-B(c) because of L2 benefit
    and 5-12us launch overhead, both modeled here.
    """
    bw = working_set_blend(w.working_set_bytes or w.bytes, hw)
    t_mem = w.bytes / bw
    rate = hw.sustained_flops(w.precision, matrix=w.matrix)
    t_comp = w.flops / rate if w.flops > 0 else 0.0
    if w.irregular:
        # Obs. 2: pointer-chasing violates regular-access assumptions;
        # bandwidth degrades to latency-bound. Model as 4x bandwidth loss.
        t_mem *= 4.0
    t_sync = sync_time(hw, 1)
    total = hw.launch_latency_s + max(t_comp, t_mem) + t_sync
    total += (w.concurrent_kernels - 1) * hw.tau_interference_s
    total += (w.num_devices - 1) * hw.tau_interference_gpu_s
    return TimeBreakdown(total=total, compute=t_comp, memory=t_mem,
                         io_effective=t_mem, sync=t_sync,
                         launch=hw.launch_latency_s,
                         detail={"bw_eff": bw})


def predict(w: Workload, hw: HardwareParams, *,
            two_sm: bool = False, n_bar: int = 1) -> TimeBreakdown:
    """Stage-centric Blackwell prediction (paper §IV-A).

    Tiled-GEMM workloads (w.tile/w.gemm set) take the full TMA->TMEM->TC
    pipeline; everything else takes the bandwidth stage.
    """
    if hw.model_family not in ("blackwell", "tpu"):
        raise ValueError(f"blackwell model mis-routed to {hw.name}")
    if w.gemm is not None or (w.tile is not None and w.k_tiles > 0):
        return _tiled_gemm_predict(w, hw, two_sm=two_sm, n_bar=n_bar)
    return _streaming_predict(w, hw)


# ---------------------------------------------------------------------------
# Columnar (NumPy-vectorized) stage model — the WorkloadTable / SweepEngine
# hot path.  Bit-identical to the scalar functions above: every elementwise
# expression mirrors the scalar operation order, and transcendentals ride the
# libm-exact helpers in core.cache.
# ---------------------------------------------------------------------------

def _tiled_gemm_cols(table, hw: HardwareParams):
    from .workload import NV_BM, NV_BN, NV_BK, NV_K_TILES, NV_NUM_CTAS, \
        NV_WS, NV_BYTES_PER_CTA, NV_TMA_P, NV_COMP_BYTES, NV_COMP_RATIO, \
        NV_CONCURRENT, NV_DEVICES, NV_GMN, TableCols
    raw = table.cols
    bm, bn, bk = raw[:, NV_BM], raw[:, NV_BN], raw[:, NV_BK]
    k_tiles = np.maximum(raw[:, NV_K_TILES].astype(np.int64), 1)
    num_ctas = raw[:, NV_NUM_CTAS].astype(np.int64)
    wsb = raw[:, NV_WS]

    # compute_time_per_step (Eq. 3/6), two_sm=False, sustained=True
    flops = 2.0 * bm * bn * bk
    rate = table.per_precision(
        lambda p: hw.sustained_flops(p, matrix=True))
    eff = table.per_precision(
        lambda p: hw.precision_efficiency.get(p, 1.0))
    in_b = table.per_precision(lambda p: BYTES_PER_ELEM[p])
    r_sm = rate / hw.num_sms
    t_mma = flops / (r_sm * 1.0 * eff)
    d_accum = bm * bn * ACCUM_BYTES
    spill = d_accum > hw.accum_capacity_bytes
    bw_r = hw.accum_read_bw / hw.num_sms
    bw_w = hw.accum_write_bw / hw.num_sms
    t_tile = d_accum / bw_r + hw.cycles_to_seconds(hw.mma_latency_cycles) \
        + d_accum / bw_w
    t_tile = np.where(spill, t_tile * 2.0, t_tile)
    t_tmem = np.where(spill, t_tile, t_tile / k_tiles)
    t_comp = t_mma + t_tmem + hw.tmem_alloc_latency_s / k_tiles

    # tma_time_per_step (Eq. 4)
    m_a = bm * bk * in_b
    m_b = bk * bn * in_b
    bytes_step = m_a + m_b
    bpc = raw[:, NV_BYTES_PER_CTA]
    bytes_step = np.where(bpc > 0, bpc, bytes_step)
    active = np.maximum(
        1, np.minimum(np.where(num_ctas != 0, num_ctas, hw.num_sms),
                      hw.num_sms))
    b_tma = working_set_blend_batch(
        wsb, hw, peak=hw.tma_bandwidth * 1.35, sustained=hw.tma_bandwidth)
    per_cta_bw = b_tma / active
    p = np.maximum(1.0, raw[:, NV_TMA_P])
    t_tma = hw.cycles_to_seconds(hw.tma_latency_cycles) \
        + bytes_step / (p * per_cta_bw)

    # decompression (Eq. 5)
    comp_b = raw[:, NV_COMP_BYTES]
    if comp_b.any():
        comp_r = raw[:, NV_COMP_RATIO]
        link = max(
            min(hw.hbm_sustained_bw, hw.decomp_engine_rate or math.inf), 1.0)
        with np.errstate(divide="ignore", invalid="ignore"):
            d_unc = comp_b * comp_r
            t_de = np.where(
                comp_b > 0,
                d_unc / (comp_r * link * hw.decomp_efficiency), 0.0)
        t_dec = t_de / np.maximum(num_ctas * k_tiles, 1)
    else:
        t_dec = 0.0  # scalar path yields exactly 0.0 here

    t_sync = sync_time(hw, 1)
    alpha = hw.pipeline_overlap_alpha
    t_io_eff = (1.0 - alpha) * (t_tma + t_dec) + t_sync           # Eq. 7
    t_step = np.maximum(t_comp, t_io_eff) + t_sync + 0.0          # Eq. 8

    waves = np.maximum(1.0, np.maximum(num_ctas, 1) / hw.num_sms)
    t_fill = t_tma + t_dec
    t_body = waves * k_tiles * t_step

    t_store = (1.0 - alpha) * (raw[:, NV_GMN] * in_b) / hw.hbm_sustained_bw

    total = hw.launch_latency_s + t_fill + t_body + t_store
    total = total + (raw[:, NV_CONCURRENT] - 1) * hw.tau_interference_s
    total = total + (raw[:, NV_DEVICES] - 1) * hw.tau_interference_gpu_s

    return TableCols(
        len(table),
        (total, waves * k_tiles * t_comp, waves * k_tiles * t_tma,
         waves * k_tiles * t_io_eff, waves * k_tiles * t_sync,
         hw.launch_latency_s, t_store, 0.0, 0.0),
        ("t_step", "t_compute_step", "t_tma_step", "t_sync_step",
         "waves", "k_tiles", "pipeline_fill"),
        (t_step, t_comp, t_tma, t_sync, waves,
         k_tiles.astype(np.float64), t_fill))


def _streaming_cols(table, hw: HardwareParams):
    from .workload import NV_BYTES, NV_WS_OR_BYTES, NV_FLOPS, \
        NV_IRREGULAR, NV_CONCURRENT, NV_DEVICES, TableCols
    raw = table.cols
    nbytes, wsb, flops = raw[:, NV_BYTES], raw[:, NV_WS_OR_BYTES], \
        raw[:, NV_FLOPS]
    bw = working_set_blend_batch(wsb, hw)
    t_mem = nbytes / bw
    rate = table.per_precision_matrix(
        lambda p, m: hw.sustained_flops(p, matrix=m))
    with np.errstate(divide="ignore", invalid="ignore"):
        t_comp = np.where(flops > 0, flops / rate, 0.0)
    t_mem = np.where(raw[:, NV_IRREGULAR] != 0, t_mem * 4.0, t_mem)
    t_sync = sync_time(hw, 1)
    total = hw.launch_latency_s + np.maximum(t_comp, t_mem) + t_sync
    total = total + (raw[:, NV_CONCURRENT] - 1) * hw.tau_interference_s
    total = total + (raw[:, NV_DEVICES] - 1) * hw.tau_interference_gpu_s

    return TableCols(
        len(table),
        (total, t_comp, t_mem, t_mem, t_sync, hw.launch_latency_s,
         0.0, 0.0, 0.0),
        ("bw_eff",), (bw,))


def predict_table_cols(table, hw: HardwareParams):
    """Columnar ``predict`` over a WorkloadTable (defaults two_sm=False,
    n_bar=1).  Bit-identical per row to scalar ``predict``."""
    from .workload import NV_HAS_GEMM, NV_HAS_TILE, NV_K_TILES, SegmentedCols
    if hw.model_family not in ("blackwell", "tpu"):
        raise ValueError(f"blackwell model mis-routed to {hw.name}")
    raw = table.cols
    tiled = (raw[:, NV_HAS_GEMM] != 0) | \
        ((raw[:, NV_HAS_TILE] != 0) & (raw[:, NV_K_TILES] > 0))
    if tiled.all():
        return _tiled_gemm_cols(table, hw)
    if not tiled.any():
        return _streaming_cols(table, hw)
    idx_t = np.flatnonzero(tiled)
    idx_s = np.flatnonzero(~tiled)
    return SegmentedCols(len(table), [
        (idx_t, _tiled_gemm_cols(table.take(idx_t), hw)),
        (idx_s, _streaming_cols(table.take(idx_s), hw))])


def predict_rows(ws: Sequence[Workload], hw: HardwareParams) -> List[Row]:
    """Vectorized ``predict`` over a workload batch, in row form (defaults
    two_sm=False, n_bar=1).  Bit-identical to per-workload ``predict``."""
    from .workload import WorkloadTable
    return predict_table_cols(WorkloadTable.from_workloads(ws), hw).rows()


def predict_batch(ws: Sequence[Workload],
                  hw: HardwareParams) -> List[TimeBreakdown]:
    """Materialized form of ``predict_rows``."""
    return [tb_from_row(r) for r in predict_rows(ws, hw)]


def two_sm_traffic_reduction(tile: TileConfig) -> float:
    """§IV-A4: D_2CTA = 2M_A + M_B vs 2(M_A + M_B); ~1.33x for square."""
    m_a = tile.bm * tile.bk
    m_b = tile.bk * tile.bn
    return 2.0 * (m_a + m_b) / (2.0 * m_a + m_b)


def two_sm_speedup(w: Workload, hw: HardwareParams) -> float:
    """Predicted end-to-end speedup of CTA-pair execution on a
    memory(TMA)-bound kernel (§V-B(c): predicted 1.30x vs measured 1.28x).

    The prediction comes from the §IV-A4 traffic argument: the pair shares B
    via DSMEM, cutting operand traffic by 2(M_A+M_B)/(2M_A+M_B) (~1.33x for
    square tiles), degraded by the per-K-step commit barrier the pair adds
    (K_tiles * L_commit, pipelined so only the (1-alpha) fraction is
    exposed):
        S_2SM = traffic_reduction * T_step / (T_step + (1-alpha) L_commit)
    """
    tile = w.tile or TileConfig()
    reduction = two_sm_traffic_reduction(tile)
    t_step = predict(w, hw, two_sm=False).detail["t_step"]
    l_commit = hw.cycles_to_seconds(hw.commit_latency_cycles)
    exposed = (1.0 - hw.pipeline_overlap_alpha) * l_commit
    return reduction * t_step / (t_step + exposed)
