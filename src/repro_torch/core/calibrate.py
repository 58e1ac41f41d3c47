"""Calibration: per-case multipliers with train/holdout discipline.

Paper §IV-D: "First-principles parameters (bandwidths, T_launch, barrier
latencies) come from microbenchmarks.  Optional per-case multipliers may
align predictions with profiler kernel-sum times; such factors must be
disclosed.  We recommend train/holdout splits when calibration is used."

Paper Obs. 1: on MI300A, host-measured calibration multipliers take the
27-kernel suite from ~5-8% (uncalibrated) to ~0.09% MAE; both numbers are
reported because they serve different purposes.

The calibration is multiplicative per case key (exact name match, then
class match, then global), fitted as measured/predicted on the train split.
"""
from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .hardware import HardwareParams
from .workload import TimeBreakdown, Workload


@dataclass
class Calibration:
    """Disclosed per-case multipliers (paper's m_case, default 1.0).

    ``skipped`` lists kernels the fit could not use (non-positive
    predicted or measured time) — a degenerate backend must not produce
    an empty calibration that silently claims 0% train MAE.
    """

    per_case: Dict[str, float] = field(default_factory=dict)
    per_class: Dict[str, float] = field(default_factory=dict)
    global_scale: float = 1.0
    skipped: List[str] = field(default_factory=list)

    def multiplier(self, w: Workload) -> float:
        if w.name in self.per_case:
            return self.per_case[w.name]
        if w.wclass in self.per_class:
            return self.per_class[w.wclass]
        return self.global_scale

    def apply(self, w: Workload, pred: TimeBreakdown) -> TimeBreakdown:
        m = self.multiplier(w)
        out = pred.scaled(m)
        out.detail["m_case"] = m
        return out

    def disclose(self) -> Dict[str, object]:
        """Full disclosure of applied factors (paper §IV-D requirement),
        including the kernels the fit had to skip."""
        out: Dict[str, object] = {
            f"case:{k}": v for k, v in self.per_case.items()}
        out.update({f"class:{k}": v for k, v in self.per_class.items()})
        out["global"] = self.global_scale
        if self.skipped:
            out["skipped"] = list(self.skipped)
        return out

    # ------------------------------------------------------- serialization
    def to_dict(self) -> Dict:
        """JSON-safe form — what ``serve.codec`` ships over the wire.
        Multipliers travel in full (the §IV-D disclosure is the payload,
        not an attachment)."""
        return {"per_case": dict(self.per_case),
                "per_class": dict(self.per_class),
                "global_scale": self.global_scale,
                "skipped": list(self.skipped)}

    @staticmethod
    def from_dict(d: Dict) -> "Calibration":
        """Validated inverse of ``to_dict``."""
        if not isinstance(d, dict):
            raise ValueError(f"calibration payload must be a dict, got "
                             f"{type(d).__name__}")
        unknown = set(d) - {"per_case", "per_class", "global_scale",
                            "skipped"}
        if unknown:
            raise ValueError(f"unknown calibration key(s): "
                             f"{sorted(unknown)}")

        def _mults(key: str) -> Dict[str, float]:
            raw = d.get(key, {})
            if not isinstance(raw, dict):
                raise ValueError(f"{key} must be a dict")
            return {str(k): float(v) for k, v in raw.items()}

        return Calibration(
            per_case=_mults("per_case"), per_class=_mults("per_class"),
            global_scale=float(d.get("global_scale", 1.0)),
            skipped=[str(s) for s in d.get("skipped", [])])


PredictFn = Callable[[Workload], TimeBreakdown]


def fit_per_case(workloads: Sequence[Workload],
                 measured: Sequence[float],
                 predict_fn: PredictFn) -> Calibration:
    """m_case = measured / predicted, one per kernel (ceiling accuracy —
    what the paper's ~0.09% MI300A result does)."""
    cal = Calibration()
    for w, t_meas in zip(workloads, measured):
        t_pred = predict_fn(w).total
        if t_pred > 0:
            cal.per_case[w.name] = t_meas / t_pred
        else:
            # a degenerate backend (every prediction 0) must not yield an
            # empty calibration that claims perfect train MAE
            cal.skipped.append(w.name)
    return cal


def fit_per_class(workloads: Sequence[Workload],
                  measured: Sequence[float],
                  predict_fn: PredictFn) -> Calibration:
    """Geometric-mean multiplier per workload class (the paper's
    'separate calibrated scales for memory/compute/balanced/stencil')."""
    logs: Dict[str, List[float]] = {}
    cal = Calibration()
    for w, t_meas in zip(workloads, measured):
        t_pred = predict_fn(w).total
        if t_pred > 0 and t_meas > 0:
            logs.setdefault(w.wclass, []).append(math.log(t_meas / t_pred))
        else:
            cal.skipped.append(w.name)
    for cls, vals in logs.items():
        cal.per_class[cls] = math.exp(sum(vals) / len(vals))
    return cal


def train_holdout_split(
        workloads: Sequence[Workload], measured: Sequence[float],
        *, holdout_fraction: float = 0.3, seed: int = 0,
) -> Tuple[List[int], List[int]]:
    """Deterministic stratified-ish split (paper's recommended discipline)."""
    idx = list(range(len(workloads)))
    rng = random.Random(seed)
    rng.shuffle(idx)
    n_hold = max(1, int(round(len(idx) * holdout_fraction)))
    return idx[n_hold:], idx[:n_hold]


def fit_with_holdout(workloads: Sequence[Workload],
                     measured: Sequence[float],
                     predict_fn: PredictFn, *,
                     mode: str = "class",
                     holdout_fraction: float = 0.3,
                     seed: int = 0) -> Tuple[Calibration, Dict[str, float]]:
    """Fit on train split, report MAE on both splits (no leakage)."""
    from .validate import mae_percent

    train_idx, hold_idx = train_holdout_split(
        workloads, measured, holdout_fraction=holdout_fraction, seed=seed)
    tw = [workloads[i] for i in train_idx]
    tm = [measured[i] for i in train_idx]
    fit = fit_per_case if mode == "case" else fit_per_class
    cal = fit(tw, tm, predict_fn)

    def calibrated(w: Workload) -> float:
        return cal.apply(w, predict_fn(w)).total

    report = {
        "train_mae": mae_percent(
            [calibrated(workloads[i]) for i in train_idx],
            [measured[i] for i in train_idx]),
        "holdout_mae": mae_percent(
            [calibrated(workloads[i]) for i in hold_idx],
            [measured[i] for i in hold_idx]),
        "n_train": float(len(train_idx)),
        "n_holdout": float(len(hold_idx)),
        "n_skipped": float(len(cal.skipped)),
    }
    return cal, report
