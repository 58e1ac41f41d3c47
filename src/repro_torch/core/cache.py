"""Cache / working-set models.

Implements:
  * paper Table III — MI300A Infinity Cache hit-rate model h_LLC(W),
  * BW_effective = h_LLC * BW_LLC + (1 - h_LLC) * BW_HBM,
  * paper Eq. 16  — working-set-aware bandwidth blend
        B_eff(W) = B_sustained + (B_peak - B_sustained) * exp(-W / w0),
  * paper Eq. 10  — expected-latency hierarchy walk.

Each model also has a ``*_batch`` variant operating on NumPy arrays of
working-set sizes (the SweepEngine hot path).  Batch variants are
bit-identical to the scalar ones: elementwise arithmetic follows the same
operation order, and the transcendentals go through ``vexp``/``vpow`` —
per-element ``math.exp``/``pow`` — because NumPy's SIMD ``np.exp`` /
``np.power`` differ from libm in the last ulp on some platforms.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import numpy as np

from .hardware import HardwareParams


def vexp(x: np.ndarray) -> np.ndarray:
    """Elementwise exp, bit-identical to scalar ``math.exp``.

    Sweeps typically share few distinct working-set sizes (a tile sweep
    varies tiles, not operands), so evaluate on the unique values when that
    pays for the sort.
    """
    x = np.asarray(x, dtype=np.float64)
    if x.size > 64:
        uniq, inv = np.unique(x, return_inverse=True)
        if uniq.size * 2 <= x.size:
            vals = np.fromiter((math.exp(v) for v in uniq),
                               np.float64, uniq.size)
            return vals[inv].reshape(x.shape)
    return np.fromiter((math.exp(v) for v in x.ravel()),
                       np.float64, x.size).reshape(x.shape)


def vpow(base: np.ndarray, exponent: float) -> np.ndarray:
    """Elementwise power, bit-identical to scalar ``float ** float``."""
    base = np.asarray(base, dtype=np.float64)
    return np.fromiter((v ** exponent for v in base.ravel()),
                       np.float64, base.size).reshape(base.shape)


def llc_hit_rate(working_set_bytes: float, hw: HardwareParams) -> float:
    """Piecewise h_LLC(W) per paper Table III.

    W < resident          -> 1.0                     (fully cache-resident)
    resident <= W <= cap  -> (1 - (W-res)/(cap-res))^alpha   (transition)
    W > cap               -> (cap / W)^beta          (streaming / spill)
    """
    w_mb = working_set_bytes / 1e6
    res = hw.llc_resident_mb
    cap = hw.llc_capacity_mb
    if cap <= 0:
        return 0.0
    if w_mb < res:
        return 1.0
    if w_mb <= cap:
        frac = 1.0 - (w_mb - res) / max(cap - res, 1e-9)
        return max(0.0, frac) ** hw.llc_transition_alpha
    return (cap / w_mb) ** hw.llc_transition_beta


def effective_bandwidth_llc(working_set_bytes: float,
                            hw: HardwareParams,
                            h_llc: Optional[float] = None) -> float:
    """BW_effective = h_LLC * BW_LLC + (1 - h_LLC) * BW_HBM (paper §IV-B)."""
    if not hw.cache_levels:
        return hw.hbm_sustained_bw
    llc = hw.cache_levels[-1]
    h = llc_hit_rate(working_set_bytes, hw) if h_llc is None else h_llc
    return h * llc.bandwidth + (1.0 - h) * hw.hbm_sustained_bw


def working_set_blend(working_set_bytes: float, hw: HardwareParams,
                      *, peak: Optional[float] = None,
                      sustained: Optional[float] = None) -> float:
    """Paper Eq. 16: B_eff(W) = B_sus + (B_peak - B_sus) exp(-W/w0).

    Captures that small resident working sets see higher effective bandwidth
    than HBM-saturating streams.  w0 <= 0 disables the blend (returns
    sustained).
    """
    b_peak = hw.hbm_peak_bw if peak is None else peak
    b_sus = hw.hbm_sustained_bw if sustained is None else sustained
    w0 = hw.working_set_scale_bytes
    if w0 <= 0:
        return b_sus
    return b_sus + (b_peak - b_sus) * math.exp(-working_set_bytes / w0)


def llc_hit_rate_batch(working_set_bytes: np.ndarray,
                       hw: HardwareParams) -> np.ndarray:
    """Vectorized ``llc_hit_rate`` (bit-identical per element)."""
    w_mb = np.asarray(working_set_bytes, dtype=np.float64) / 1e6
    res = hw.llc_resident_mb
    cap = hw.llc_capacity_mb
    out = np.zeros_like(w_mb)
    if cap <= 0:
        return out
    out[w_mb < res] = 1.0
    mid = (w_mb >= res) & (w_mb <= cap)
    if mid.any():
        frac = 1.0 - (w_mb[mid] - res) / max(cap - res, 1e-9)
        out[mid] = vpow(np.maximum(0.0, frac), hw.llc_transition_alpha)
    hi = w_mb > cap
    if hi.any():
        out[hi] = vpow(cap / w_mb[hi], hw.llc_transition_beta)
    return out


def effective_bandwidth_llc_batch(working_set_bytes: np.ndarray,
                                  hw: HardwareParams) -> np.ndarray:
    """Vectorized ``effective_bandwidth_llc`` (no per-workload h override —
    callers with explicit hit rates take the scalar path)."""
    ws = np.asarray(working_set_bytes, dtype=np.float64)
    if not hw.cache_levels:
        return np.full(ws.shape, hw.hbm_sustained_bw)
    llc = hw.cache_levels[-1]
    h = llc_hit_rate_batch(ws, hw)
    return h * llc.bandwidth + (1.0 - h) * hw.hbm_sustained_bw


def working_set_blend_batch(working_set_bytes: np.ndarray,
                            hw: HardwareParams, *,
                            peak: Optional[float] = None,
                            sustained: Optional[float] = None) -> np.ndarray:
    """Vectorized ``working_set_blend`` (bit-identical per element)."""
    ws = np.asarray(working_set_bytes, dtype=np.float64)
    b_peak = hw.hbm_peak_bw if peak is None else peak
    b_sus = hw.hbm_sustained_bw if sustained is None else sustained
    w0 = hw.working_set_scale_bytes
    if w0 <= 0:
        return np.full(ws.shape, b_sus)
    return b_sus + (b_peak - b_sus) * vexp(-ws / w0)


def hierarchy_latency_walk(num_loads: float,
                           hit_rates: Dict[str, float],
                           hw: HardwareParams) -> float:
    """Paper Eq. 10 expected-latency memory time (seconds).

    T = N_loads * ( h_L1*L_L1 + (1-h_L1)h_L2*L_L2
                   + (1-h_L1)(1-h_L2)h_LLC*L_LLC + (1-h_total)*L_HBM )

    Hit rates outside [0,1] are rejected.  Missing levels contribute nothing.
    """
    for k, v in hit_rates.items():
        if not (0.0 <= v <= 1.0):
            raise ValueError(f"hit rate {k}={v} outside [0, 1]")
    levels = {c.name: c for c in hw.cache_levels}
    h1 = hit_rates.get("l1", 0.0)
    h2 = hit_rates.get("l2", 0.0)
    hllc = hit_rates.get("llc", 0.0)

    expected_cycles = 0.0
    miss = 1.0
    if "l1" in levels:
        expected_cycles += h1 * levels["l1"].latency_cycles
        miss = (1.0 - h1)
    if "l2" in levels:
        expected_cycles += miss * h2 * levels["l2"].latency_cycles
        miss = miss * (1.0 - h2)
    if "llc" in levels:
        expected_cycles += miss * hllc * levels["llc"].latency_cycles
        miss = miss * (1.0 - hllc)
    expected_cycles += miss * hw.hbm_latency_cycles
    return num_loads * hw.cycles_to_seconds(expected_cycles)
