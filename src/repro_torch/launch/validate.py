"""The paper's loop on the device: microbenchmark -> parameters -> predict ->
validate, with the calibration ladder (paper Obs. 1).  Counterpart of
``benchmarks/tables.py:table_cpuhost`` and its ``_batched_pf`` helper.

    PYTHONPATH=src python -m repro_torch.launch.validate            # the card
    PYTHONPATH=src python -m repro_torch.launch.validate --quick --device cpu

``table_device`` measures the device (``core.microbench.calibrate_device``),
times the validation suite on it (``device_suite_result``) and prices the
suite through the port's copy of the analytical model.  The ladder:
uncalibrated with the measured parameters, uncalibrated with the parameter
file the measurements started from (the datasheet ``h100`` on the card),
class-calibrated (fit on a train split, MAE on the holdout) and per-case
calibrated; each beside the naive roofline's MAE on the same cases.
"""
from __future__ import annotations

import argparse
import json
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ..core import calibrate, microbench, sweep, validate
from ..core.hardware import HardwareParams
from ..core.validate import ValidationReport
from ..device import DeviceLike, resolve_device


def _batched_pf(ws, hw):
    """Scalar predict-fn for the calibrate.fit_* APIs, backed by ONE
    columnar WorkloadTable query — every subsequent per-workload call
    materializes a row from the table result (identity-matched), falling
    back to the memoized engine for foreign workloads."""
    from ..core.workload import WorkloadTable
    res = sweep.predict_table(WorkloadTable.from_workloads(ws), hw)
    index = {id(w): i for i, w in enumerate(ws)}

    def pf(w):
        i = index.get(id(w))
        if i is not None:
            return res[i]
        return sweep.default_engine().predict(w, hw)
    return pf


@dataclass
class Ladder:
    """One run of the loop: the suite, the parameters, and every rung of the
    calibration ladder."""

    suite: microbench.MeasuredSuite
    measured: ValidationReport      # uncalibrated, measured parameters
    base: ValidationReport          # uncalibrated, the file they updated
    class_holdout: Dict[str, float]  # fit_with_holdout's report
    holdout_roofline_mae: float     # roofline MAE on the same holdout cases
    per_case: ValidationReport      # per-case calibrated, measured params

    def rows(self) -> List[Dict]:
        """One row per case, as ``table_cpuhost`` gives them, plus the
        model's error with the base parameter file."""
        base = {r.name: r for r in self.base.rows}
        return [{
            "kernel": r.name, "class": r.wclass,
            "measured_us": round(r.measured_s * 1e6, 1),
            "model_us": round(r.model_s * 1e6, 1),
            "model_err_pct": round(r.model_err, 1),
            "roofline_err_pct": round(r.roofline_err, 1),
            "base_model_err_pct": round(base[r.name].model_err, 1),
        } for r in self.measured.rows]

    def maes(self) -> Dict[str, Dict[str, float]]:
        """The four MAEs (percent), each beside the roofline's on the same
        cases with the same parameters."""
        return {
            "uncalibrated_measured": {
                "model": self.measured.model_mae,
                "roofline": self.measured.roofline_mae},
            "uncalibrated_base": {
                "model": self.base.model_mae,
                "roofline": self.base.roofline_mae},
            "class_calibrated_holdout": {
                "model": self.class_holdout["holdout_mae"],
                "roofline": self.holdout_roofline_mae},
            "per_case": {
                "model": self.per_case.model_mae,
                "roofline": self.per_case.roofline_mae},
        }

    def derived(self) -> str:
        return (f"REAL measurements on {self.measured.platform}: uncal "
                f"{self.measured.model_mae:.0f}% vs roofline "
                f"{self.measured.roofline_mae:.0f}% (base "
                f"{self.base.platform}: {self.base.model_mae:.0f}% vs "
                f"{self.base.roofline_mae:.0f}%); class-cal holdout "
                f"{self.class_holdout['holdout_mae']:.0f}%; per-case "
                f"{self.per_case.model_mae:.2f}%")


def ladder(hw: HardwareParams, suite: microbench.MeasuredSuite,
           base: HardwareParams) -> Ladder:
    """Price ``suite`` with the measured ``hw`` and with ``base`` and climb
    the calibration ladder (the steps of ``table_cpuhost``)."""
    ws, meas = suite.workloads, suite.measured_s
    rep = validate.validate_suite(hw, ws, meas)
    rep_base = validate.validate_suite(base, ws, meas)

    pf = _batched_pf(ws, hw)
    _, cal_report = calibrate.fit_with_holdout(ws, meas, pf, mode="class")
    _, hold_idx = calibrate.train_holdout_split(ws, meas)
    hold_roofline = validate.mae_percent(
        [rep.rows[i].roofline_s for i in hold_idx],
        [rep.rows[i].measured_s for i in hold_idx])
    cal_p = calibrate.fit_per_case(ws, meas, pf)
    repp = validate.validate_suite(hw, ws, meas, calibration=cal_p)
    return Ladder(suite=suite, measured=rep, base=rep_base,
                  class_holdout=cal_report,
                  holdout_roofline_mae=hold_roofline, per_case=repp)


def validate_device(quick: bool = True, device: DeviceLike = None
                    ) -> Tuple[HardwareParams, Ladder]:
    """The genuinely-measured leg on the device: microbenchmark it,
    calibrate, predict, validate (paper methodology end-to-end).  Returns
    the measured parameters and the ladder."""
    dev = resolve_device(device)
    hw = microbench.calibrate_device(quick=quick, device=dev)
    suite = microbench.device_suite_result(quick=quick, device=dev)
    return hw, ladder(hw, suite, microbench.base_params(dev))


def table_device(quick: bool = True, device: DeviceLike = None
                 ) -> Tuple[List[Dict], str]:
    """``validate_device`` as a paper table: (rows, derived), the shape of
    ``table_cpuhost``."""
    _, lad = validate_device(quick=quick, device=device)
    return lad.rows(), lad.derived()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="the reference's quick sizes (default: the card's "
                         "set, core.microbench.CARD)")
    ap.add_argument("--device", default=None,
                    help="'cpu' to run on the host (default: the card)")
    args = ap.parse_args(argv)
    rows, derived = table_device(quick=args.quick, device=args.device)
    for row in rows:
        print(json.dumps(row))
    print(derived)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
