"""Validation harness: MAE / IQR statistics and model-vs-roofline comparison
(paper §V).

Protocol (paper §V-B): each kernel runs 100 times after 10 warm-ups; median
execution time is the measurement; MAE is the mean of per-kernel absolute
percent errors.  All reported MAE values use the base model (MWP=CWP=0).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .hardware import HardwareParams
from .workload import TimeBreakdown, Workload


def pct_error(predicted: float, measured: float) -> float:
    return abs(predicted - measured) / max(abs(measured), 1e-30) * 100.0


def mae_percent(predicted: Sequence[float],
                measured: Sequence[float]) -> float:
    if not predicted:
        return 0.0
    errs = [pct_error(p, m) for p, m in zip(predicted, measured)]
    return sum(errs) / len(errs)


def iqr(values: Sequence[float]) -> float:
    s = sorted(values)
    n = len(s)
    if n < 4:
        return 0.0

    def q(p: float) -> float:
        pos = p * (n - 1)
        lo = int(pos)
        hi = min(lo + 1, n - 1)
        return s[lo] + (s[hi] - s[lo]) * (pos - lo)

    return q(0.75) - q(0.25)


@dataclass
class ValidationRow:
    name: str
    wclass: str
    measured_s: float
    model_s: float
    roofline_s: float

    @property
    def model_err(self) -> float:
        return pct_error(self.model_s, self.measured_s)

    @property
    def roofline_err(self) -> float:
        return pct_error(self.roofline_s, self.measured_s)


@dataclass
class ValidationReport:
    """Table-VI-shaped result: model MAE vs naive-roofline error."""

    platform: str
    rows: List[ValidationRow] = field(default_factory=list)

    @property
    def n(self) -> int:
        return len(self.rows)

    @property
    def model_mae(self) -> float:
        return mae_percent([r.model_s for r in self.rows],
                           [r.measured_s for r in self.rows])

    @property
    def roofline_mae(self) -> float:
        return mae_percent([r.roofline_s for r in self.rows],
                           [r.measured_s for r in self.rows])

    def per_class_mae(self) -> Dict[str, float]:
        by: Dict[str, List[ValidationRow]] = {}
        for r in self.rows:
            by.setdefault(r.wclass, []).append(r)
        return {cls: mae_percent([r.model_s for r in rs],
                                 [r.measured_s for r in rs])
                for cls, rs in by.items()}

    def summary(self) -> Dict[str, float]:
        return {"n": float(self.n), "model_mae": self.model_mae,
                "roofline_mae": self.roofline_mae}


def validate_suite(platform_hw: HardwareParams,
                   workloads: Sequence[Workload],
                   measured: Sequence[float], *,
                   calibration=None,
                   model: Optional[str] = None,
                   chunk_size: Optional[int] = None,
                   jobs=None) -> ValidationReport:
    """Run model + naive roofline over a suite with known measured times.

    The suite is lifted into one columnar ``WorkloadTable`` and priced
    through the shared SweepEngine's table path — one column query per
    route, memoized whole, so repeated validation of the same suite is a
    single content-token hit per route.

    ``chunk_size``/``jobs`` switch pricing to the streaming/sharded
    executor (``core.sweep.predict_totals_stream``): peak memory bounded
    by chunk, throughput scaled across workers (0/"auto" =
    ``os.cpu_count()``) — identical totals either way, so arbitrarily
    large suites validate without materializing result columns.
    """
    from . import sweep
    from .workload import WorkloadTable
    assert len(workloads) == len(measured)
    table = WorkloadTable.from_workloads(workloads)
    if chunk_size is None and jobs is None:
        t_models = sweep.predict_table(
            table, platform_hw, model=model, calibration=calibration).totals
        t_roofs = sweep.predict_table(table, platform_hw,
                                      model="roofline").totals
    elif sweep.effective_jobs(jobs) > 1:
        # one pool + one shared-memory export prices both routes per shard
        from . import parallel
        (m_red,), (r_red,) = parallel.reduce_sharded_multi(
            table, platform_hw,
            [((sweep.TotalsStream,), model, calibration),
             ((sweep.TotalsStream,), "roofline", None)],
            jobs=jobs, chunk_size=chunk_size)
        t_models = m_red.result()
        t_roofs = r_red.result()
    else:
        t_models = sweep.predict_totals_stream(
            table, platform_hw, model=model, calibration=calibration,
            chunk_size=chunk_size)
        t_roofs = sweep.predict_totals_stream(
            table, platform_hw, model="roofline", chunk_size=chunk_size)
    rep = ValidationReport(platform=platform_hw.name)
    for w, t_meas, t_model, t_roof in zip(workloads, measured,
                                          t_models, t_roofs):
        rep.rows.append(ValidationRow(
            name=w.name, wclass=w.wclass, measured_s=t_meas,
            model_s=float(t_model), roofline_s=float(t_roof)))
    return rep


def measure_median(fn: Callable[[], None], *, repeats: int = 100,
                   warmups: int = 10,
                   timer: Optional[Callable[[], float]] = None
                   ) -> Tuple[float, float]:
    """Paper's measurement protocol: warmups, repeats, median (+ IQR%).

    ``fn`` must block until the work is done (e.g. block_until_ready)."""
    import time
    clock = timer or time.perf_counter
    for _ in range(warmups):
        fn()
    samples = []
    for _ in range(repeats):
        t0 = clock()
        fn()
        samples.append(clock() - t0)
    samples.sort()
    med = samples[len(samples) // 2]
    spread = iqr(samples) / max(med, 1e-30) * 100.0
    return med, spread
