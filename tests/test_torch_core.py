"""The port's copy of the analytical model (``repro_torch.core``, numpy only)
against the reference ``repro.core`` on the CPU.

The copies are verbatim: the same workloads, crossed from the reference as
``to_dict()`` dicts, must get bit-identical totals on every hardware file and
every route, the same calibration multipliers, and the same validation
report whether the suite is priced in one process or sharded over workers.
"""
import filecmp
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import calibrate as ref_calibrate  # noqa: E402
from repro.core import hardware as ref_hardware  # noqa: E402
from repro.core import sweep as ref_sweep  # noqa: E402
from repro.core import validate as ref_validate  # noqa: E402
from repro.core.suites import b200_microbench, mi300a_microbench, ports, \
    split  # noqa: E402
from repro.core.workload import WorkloadTable as RefTable  # noqa: E402
from repro_torch.core import calibrate, hardware, sweep, validate  # noqa: E402
from repro_torch.core import microbench  # noqa: E402
from repro_torch.core.workload import Workload, WorkloadTable  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
REF_CORE = ROOT / "src" / "repro" / "core"
PORT_CORE = ROOT / "src" / "repro_torch" / "core"
ROUTES = sweep.ROUTES

# Modules copied verbatim (only import lines may differ).
COPIED = ("hardware", "hwlib", "workload", "cache", "roofline", "generic",
          "blackwell", "cdna3", "collectives", "tpu", "sweep", "parallel",
          "predict", "validate", "calibrate", "autotune", "segments",
          "suites/__init__", "suites/b200_microbench",
          "suites/mi300a_microbench", "suites/rodinia", "suites/spechpc",
          "suites/ports")
# The deliberate differences: (module, port text, reference text).
CHANGED = {
    "predict": [
        ("from repro_torch.core import", "from repro.core import"),
        ("from repro_torch.core.workload", "from repro.core.workload")],
    "parallel": [
        ('    # The reference\'s condition names "jax".  In the port the '
         'hazard is\n    # torch: it starts its intra-op thread pool when '
         'imported, and a forked\n    # child cannot use the parent\'s CUDA '
         'context.  In the port this refuses\n    # fork always: importing '
         'this module runs core/__init__, which imports\n    # microbench '
         'and so torch.  Every pool is a forkserver (or spawn).\n', ""),
        ('"torch" not in sys.modules', '"jax" not in sys.modules'),
        ("once ``torch`` is loaded", "once ``jax`` is loaded"),
        ("(torch loaded, or any live", "(jax loaded, or any live"),
        ("re-importing repro_torch.core.", "re-importing repro.core."),
    ],
}


def _ref_workloads():
    ws = (b200_microbench.workloads() + mi300a_microbench.workloads()
          + mi300a_microbench.occupancy_tile_cases()
          + [b200_microbench.two_sm_case()] + ports.mi250x_workloads())
    return ws


def _crossed(ref_ws):
    return [Workload.from_dict(w.to_dict()) for w in ref_ws]


def _quick_suite_workloads():
    return [w for w, _ in microbench.suite_cases(quick=True, device="cpu")]


@pytest.mark.parametrize("module", COPIED)
def test_copied_module_is_the_reference_but_for_its_imports(module):
    port = (PORT_CORE / f"{module}.py").read_text()
    ref = (REF_CORE / f"{module}.py").read_text()
    for port_text, ref_text in CHANGED.get(module, ()):
        assert port_text in port
        port = port.replace(port_text, ref_text)
    assert port == ref


def test_obs_metrics_is_the_reference():
    assert filecmp.cmp(ROOT / "src/repro_torch/obs/metrics.py",
                       ROOT / "src/repro/obs/metrics.py", shallow=False)


def test_hwdata_is_byte_identical():
    ref_files = sorted(p.name for p in (REF_CORE / "hwdata").glob("*.json"))
    port_files = sorted(p.name for p in (PORT_CORE / "hwdata").glob("*.json"))
    assert port_files == ref_files and len(ref_files) == 13
    for name in ref_files:
        assert filecmp.cmp(REF_CORE / "hwdata" / name,
                           PORT_CORE / "hwdata" / name, shallow=False), name


def test_port_reads_its_own_hwdata():
    assert Path(hardware.DATA_DIR) == PORT_CORE / "hwdata"
    assert hardware.DATA_DIR != ref_hardware.DATA_DIR


HW_NAMES = sorted(p.stem for p in (REF_CORE / "hwdata").glob("*.json"))


@pytest.mark.parametrize("hw_name", HW_NAMES)
def test_totals_bit_identical_on_every_route(hw_name):
    """Every hardware file x every route: the port's totals are the
    reference's, bit for bit."""
    ref_ws = _ref_workloads()
    port_ws = _crossed(ref_ws)
    quick = _quick_suite_workloads()
    ref_ws = ref_ws + [type(ref_ws[0]).from_dict(w.to_dict()) for w in quick]
    port_ws = port_ws + quick
    ref_hw, port_hw = ref_hardware.get(hw_name), hardware.get(hw_name)
    ref_table = RefTable.from_workloads(ref_ws)
    port_table = WorkloadTable.from_workloads(port_ws)
    priced = 0
    for route in ROUTES:
        try:
            want = ref_sweep.predict_table(ref_table, ref_hw,
                                           model=route).totals
        except ValueError as e:
            # a route refuses a family it does not model; the port refuses
            # it with the same message
            with pytest.raises(ValueError, match=str(e)):
                sweep.predict_table(port_table, port_hw, model=route)
            continue
        got = sweep.predict_table(port_table, port_hw, model=route).totals
        assert got.dtype == want.dtype
        assert np.array_equal(got, want), (hw_name, route)
        priced += 1
    assert priced >= 2          # its own route and the roofline at least
    assert sweep.default_route(port_hw) == ref_sweep.default_route(ref_hw)


def test_h100_routes_to_the_stage_model():
    assert sweep.default_route(hardware.get("h100")) == "stage"


def _b200_suite():
    ref_ws, meas = split(b200_microbench.suite())
    return ref_ws, _crossed(ref_ws), meas


def test_calibration_multipliers_match():
    ref_ws, port_ws, meas = _b200_suite()
    ref_hw, port_hw = ref_hardware.get("b200"), hardware.get("b200")

    def ref_pf(w):
        return ref_sweep.default_engine().predict(w, ref_hw)

    def port_pf(w):
        return sweep.default_engine().predict(w, port_hw)
    for mode in ("class", "case"):
        ref_cal, ref_rep = ref_calibrate.fit_with_holdout(ref_ws, meas,
                                                          ref_pf, mode=mode)
        cal, rep = calibrate.fit_with_holdout(port_ws, meas, port_pf,
                                              mode=mode)
        assert cal.per_case == ref_cal.per_case
        assert cal.per_class == ref_cal.per_class
        assert cal.global_scale == ref_cal.global_scale
        assert rep == ref_rep
    ref_p = ref_calibrate.fit_per_case(ref_ws, meas, ref_pf)
    port_p = calibrate.fit_per_case(port_ws, meas, port_pf)
    assert port_p.per_case == ref_p.per_case
    assert port_p.disclose() == ref_p.disclose()


def test_validate_suite_matches_reference_and_is_shard_invariant():
    ref_ws, port_ws, meas = _b200_suite()
    ref_rep = ref_validate.validate_suite(ref_hardware.get("b200"), ref_ws,
                                          meas)
    hw = hardware.get("b200")
    one = validate.validate_suite(hw, port_ws, meas)
    sharded = validate.validate_suite(hw, port_ws, meas, jobs=2)
    for a, b, c in zip(one.rows, sharded.rows, ref_rep.rows):
        assert (a.name, a.model_s, a.roofline_s) == (b.name, b.model_s,
                                                     b.roofline_s)
        assert (a.name, a.model_s, a.roofline_s) == (c.name, c.model_s,
                                                     c.roofline_s)
    assert one.model_mae == ref_rep.model_mae
    assert one.roofline_mae == ref_rep.roofline_mae


def test_fork_is_refused_once_torch_is_loaded():
    """The port's deliberate change: the pool never forks a process that
    has imported torch (its thread pool, and a CUDA context a child could
    not use)."""
    from repro_torch.core import parallel
    assert "torch" in __import__("sys").modules
    assert parallel._mp_context().get_start_method() != "fork"


def test_port_core_passes_the_reference_linter():
    from repro.analysis import run_checks
    from repro.analysis.rules.sweep_loop import ALLOWED_PATHS
    report = run_checks(root=str(ROOT),
                        paths=("src/repro_torch/core", "src/repro_torch/obs"),
                        rules=["SWEEP-LOOP", "FROZEN-MUT", "FORK-LOCK"])
    # The rule allow-lists the reference's suite inventories by their path
    # ("repro/core/suites/"); the port's copies of them, held to the same
    # text, are allowed the same loops.
    suites = [a.replace("repro/", "repro_torch/", 1) for a in ALLOWED_PATHS
              if "/suites/" in a]
    assert suites == ["repro_torch/core/suites/"]
    errors = [f.render() for f in report.unsuppressed()
              if not (f.rule == "SWEEP-LOOP"
                      and any(a in f.path for a in suites))]
    assert not errors, errors
    # the port's files were scanned: the suite's characterization loops
    # carry their inline allows, and those matched
    allowed = [f for f in report.findings
               if f.suppressed and f.path.endswith("core/microbench.py")]
    assert len(allowed) == 2


def test_every_reference_core_module_has_its_port():
    """The port's core holds every module of the reference's but its
    JAX-bound ``microbench`` (rewritten in torch) as a copy."""
    ref = {str(p.relative_to(REF_CORE))[:-3]
           for p in REF_CORE.rglob("*.py")} - {"__init__", "microbench"}
    assert ref == set(COPIED)
    from repro_torch import core
    for name in ("autotune", "segments"):
        assert name in core.__all__ and hasattr(core, name)
