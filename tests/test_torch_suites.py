"""The port's copies of the paper's published suites and the multi-segment
model (``repro_torch.core.suites``, ``repro_torch.core.segments``) against
the reference's (``repro.core.suites``, ``repro.core.segments``) on the CPU.

The copies are verbatim (``tests/test_torch_core.py`` holds their text).
Here their outputs are: each table's workloads, its "measured" values
(published or reconstructed from the paper's error levels; none was
measured on the card), and the MAEs that tests/test_paper_claims.py checks
against the paper, all equal to the reference's bit for bit.
"""
import pytest

pytest.importorskip("torch")

from repro.core import hardware as ref_hardware  # noqa: E402
from repro.core import segments as ref_segments  # noqa: E402
from repro.core import validate as ref_validate  # noqa: E402
from repro.core import suites as ref_suites  # noqa: E402
from repro.core.suites import b200_microbench as ref_b200  # noqa: E402
from repro.core.suites import mi300a_microbench as ref_mi300a  # noqa: E402
from repro.core.suites import ports as ref_ports  # noqa: E402
from repro.core.suites import rodinia as ref_rodinia  # noqa: E402
from repro.core.suites import spechpc as ref_spechpc  # noqa: E402
from repro_torch.core import hardware, segments, suites, validate  # noqa: E402
from repro_torch.core.suites import (  # noqa: E402
    b200_microbench, mi300a_microbench, ports, rodinia, spechpc)

# Table VI and the two ports: (name, port suite, reference suite, platform,
# cases).
TABLE_VI = [
    ("b200", b200_microbench.suite, ref_b200.suite, "b200", 21),
    ("mi300a", mi300a_microbench.suite, ref_mi300a.suite, "mi300a", 27),
    ("h200", ports.h200_suite, ref_ports.h200_suite, "h200", 21),
    ("mi250x", ports.mi250x_suite, ref_ports.mi250x_suite, "mi250x", 19),
]


def _entries_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.workload.to_dict() == w.workload.to_dict()
        assert (g.measured_s, g.provenance, g.note) == (
            w.measured_s, w.provenance, w.note)


@pytest.mark.parametrize("name,port_suite,ref_suite,platform,cases",
                         TABLE_VI, ids=[t[0] for t in TABLE_VI])
def test_table_vi_rows_and_maes_are_the_reference(name, port_suite,
                                                  ref_suite, platform,
                                                  cases):
    got, want = port_suite(), ref_suite()
    _entries_equal(got, want)
    rep = validate.validate_suite(hardware.get(platform),
                                  *suites.split(got))
    ref_rep = ref_validate.validate_suite(ref_hardware.get(platform),
                                          *ref_suites.split(want))
    assert rep.n == ref_rep.n == cases
    for a, b in zip(rep.rows, ref_rep.rows):
        assert (a.name, a.wclass, a.measured_s, a.model_s, a.roofline_s) \
            == (b.name, b.wclass, b.measured_s, b.model_s, b.roofline_s)
    assert rep.model_mae == ref_rep.model_mae
    assert rep.roofline_mae == ref_rep.roofline_mae
    # the paper's comparative claim holds in the port as in the reference
    assert rep.model_mae < rep.roofline_mae / 5.0


def test_worked_examples_are_the_reference():
    """§IV-A4 / §V-B(c): the two-SM case and the occupancy tile cases."""
    assert b200_microbench.two_sm_case().to_dict() == \
        ref_b200.two_sm_case().to_dict()
    got = [w.to_dict() for w in mi300a_microbench.occupancy_tile_cases()]
    want = [w.to_dict() for w in ref_mi300a.occupancy_tile_cases()]
    assert got == want
    assert [w.to_dict() for w in ports.mi250x_workloads()] == \
        [w.to_dict() for w in ref_ports.mi250x_workloads()]


def _segments_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.workload.to_dict() == w.workload.to_dict()
        assert (g.n_exec, g.extra_kernels) == (w.n_exec, w.extra_kernels)
        assert [vars(h) for h in g.host_phases] == \
            [vars(h) for h in w.host_phases]


def _apps_match(port_apps, ref_apps, platform):
    hw, ref_hw = hardware.get(platform), ref_hardware.get(platform)
    assert [a.name for a in port_apps] == [a.name for a in ref_apps]
    for app, ref_app in zip(port_apps, ref_apps):
        assert (app.wclass, app.measured_s, app.provenance,
                app.paper_mae_pct) == (ref_app.wclass, ref_app.measured_s,
                                       ref_app.provenance,
                                       ref_app.paper_mae_pct)
        _segments_equal(app.segments, ref_app.segments)
        pred = segments.predict_app(app.name, app.segments, hw)
        ref_pred = ref_segments.predict_app(ref_app.name, ref_app.segments,
                                            ref_hw)
        assert pred.total == ref_pred.total
        assert pred.per_segment == ref_pred.per_segment
        assert pred.mae_vs(app.measured_s) == \
            ref_pred.mae_vs(ref_app.measured_s)


@pytest.mark.parametrize("platform", ["b200", "mi300a"])
def test_table_x_rodinia_is_the_reference(platform):
    _apps_match(rodinia.apps(platform), ref_rodinia.apps(platform), platform)


@pytest.mark.parametrize("platform", ["b200", "mi300a"])
def test_table_xi_spechpc_is_the_reference(platform):
    _apps_match(spechpc.apps(platform), ref_spechpc.apps(platform), platform)


def test_table_xii_and_first_principles_are_the_reference():
    assert spechpc.flop_ratios() == ref_spechpc.flop_ratios()
    got = spechpc.first_principles_segments()
    want = ref_spechpc.first_principles_segments()
    assert sorted(got) == sorted(want)
    hw, ref_hw = hardware.get("mi300a"), ref_hardware.get("mi300a")
    for name in got:
        _segments_equal(got[name], want[name])
        assert segments.predict_app(name, tuple(got[name]), hw).total == \
            ref_segments.predict_app(name, tuple(want[name]), ref_hw).total


def test_segment_routes_are_the_reference():
    """The class -> route table and its choice on every platform file."""
    assert segments.CLASS_ROUTE == ref_segments.CLASS_ROUTE
    segs = [s for app in rodinia.apps("mi300a") for s in app.segments]
    ref_segs = [s for app in ref_rodinia.apps("mi300a")
                for s in app.segments]
    for name in ("b200", "mi300a", "h100", "tpu_v5e", "cpu_host"):
        hw, ref_hw = hardware.get(name), ref_hardware.get(name)
        assert [segments.route_for(s, hw) for s in segs] == \
            [ref_segments.route_for(s, ref_hw) for s in ref_segs]
