"""The port's microbenchmarks and validation loop (``repro_torch.core.
microbench``, ``repro_torch.launch.validate``) against the reference's
(``repro.core.microbench``, ``benchmarks/tables.py:table_cpuhost``) on the
CPU.

What a CPU run can hold: the suite's characterizations (the workloads the
model prices) equal the reference's case for case; the cases compute what
they claim (a transpose is written out); the measured suite crosses into
the reference's wire form; the calibration ladder is the reference's on the
same data; and the whole loop runs end to end at the quick sizes.  No time
measured here is a device number.  Only one test compiles and times the
suite (``torch.compile`` of the vector chain, poly_chain and the stencil).
"""
import dataclasses
import io
import json
from contextlib import redirect_stdout

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import calibrate as ref_calibrate  # noqa: E402
from repro.core import hardware as ref_hardware  # noqa: E402
from repro.core import microbench as ref_microbench  # noqa: E402
from repro.core import sweep as ref_sweep  # noqa: E402
from repro.core import validate as ref_validate  # noqa: E402
from repro.core.workload import Workload as RefWorkload  # noqa: E402
from repro_torch.core import hardware, microbench  # noqa: E402
from repro_torch.core import validate as port_core_validate  # noqa: E402
from repro_torch.kernels.matmul import kernel as matmul_kernel  # noqa: E402
from repro_torch.kernels.rmsnorm import kernel as rmsnorm_kernel  # noqa: E402
from repro_torch.launch import validate as port_validate  # noqa: E402

REF_NAMES = ["vec_copy", "vec_add", "reduction", "transpose_2d", "gemm_256",
             "gemm_512", "poly_chain", "hotspot_like_stencil"]
PORT_ONLY = ["rmsnorm_kernel", "gemm_kernel_256"]


@pytest.fixture(scope="module")
def ref_quick_workloads():
    """The reference's quick host_suite workloads, its timing loop stubbed
    out: each case still compiles and runs once, none is timed."""
    saved = ref_microbench.measure_median
    ref_microbench.measure_median = lambda fn, **kw: (1.0, 0.0)
    try:
        ws, _ = ref_microbench.host_suite(quick=True)
    finally:
        ref_microbench.measure_median = saved
    return ws


@pytest.fixture(scope="module")
def cases():
    return microbench.suite_cases(quick=True, device="cpu")


def test_characterizations_equal_the_reference(ref_quick_workloads, cases):
    ref = {w.name: w.to_dict() for w in ref_quick_workloads}
    port = {w.name: w.to_dict() for w, _ in cases}
    assert sorted(ref) == sorted(REF_NAMES)
    assert sorted(port) == sorted(REF_NAMES + PORT_ONLY)
    for name in REF_NAMES:
        assert port[name] == ref[name], name


def test_hand_written_kernel_cases_are_characterized(cases):
    ws = {w.name: w for w, _ in cases}
    n = 256
    g = ws[f"gemm_kernel_{n}"]
    assert (g.wclass, g.precision, g.matrix) == ("compute", "fp32", True)
    assert (g.flops, g.bytes) == (2.0 * n ** 3, 12.0 * n * n)
    r, d = microbench.QUICK.rmsnorm_rows, microbench.QUICK.rmsnorm_d
    rm = ws["rmsnorm_kernel"]
    assert (rm.wclass, rm.precision, rm.matrix) == ("memory", "fp32", False)
    assert (rm.flops, rm.bytes) == (4.0 * r * d, 8.0 * r * d + 4.0 * d)


def test_card_set_is_above_the_l2():
    """Every memory-class working set of the card's set is more than four
    times the H100's 50 MB L2."""
    l2 = 50 * 2 ** 20
    card = microbench.CARD
    assert 4 * card.vector_n > 4 * l2
    assert 4 * card.transpose_n ** 2 > 4 * l2
    assert 4 * card.stencil_n ** 2 > 4 * l2
    assert 4 * card.rmsnorm_rows * card.rmsnorm_d > 4 * l2
    assert card.gemms == (2048, 4096, 8192)
    assert card.gemm_kernels == (4096, 8192)
    assert (card.rmsnorm_rows, card.rmsnorm_d) == (65536, 2560)


def test_card_vector_chain_is_flop_bound():
    """The card's vector-FLOP chain does at least 4x the H100's ridge
    (67e12 FLOP/s fp32 over 3.35e12 B/s) in flops per byte moved (one fp32
    read and one write an element); the quick set keeps the reference's 4
    FMAs (``repro/core/microbench.py:134``)."""
    def flops_per_byte(sz):
        return microbench.vector_chain_flops(sz.calib_vector_n,
                                             sz.calib_vector_fmas) / (
            8.0 * sz.calib_vector_n)
    assert microbench.QUICK.calib_vector_fmas == 4
    assert flops_per_byte(microbench.QUICK) == 1.0
    assert flops_per_byte(microbench.CARD) >= 4 * 67e12 / 3.35e12


@pytest.mark.parametrize("fmas", [4, 8, 512])
def test_vector_flop_count_follows_the_chain_length(monkeypatch, fmas):
    """The rate is 2 flops an FMA, ``fmas`` FMAs on each of n elements, over
    the measured time; the chain computes those FMAs (timing stubbed, the
    chain run eagerly)."""
    n = 1 << 10
    ran = []

    def timed(fn, dev, *, repeats, warmups):
        ran.append(fn())
        return 0.5
    monkeypatch.setattr(microbench, "compiled", lambda fn: fn)
    monkeypatch.setattr(microbench, "_timed", timed)
    rate = microbench.measure_vector_flops(n, fmas=fmas, device="cpu")
    assert rate == 2.0 * fmas * n / 0.5
    want = np.ones(n, np.float32)
    for _ in range(fmas):
        want = want * np.float32(1.0001) + np.float32(0.5)
    np.testing.assert_allclose(ran[0].numpy(), want, rtol=1e-6)
    assert microbench.measure_vector_flops(n, device="cpu") == 8.0 * n / 0.5


def test_transpose_writes_a_contiguous_transpose(cases):
    calls = {w.name: call for w, call in cases}
    m = microbench.QUICK.transpose_n
    out = calls["transpose_2d"]()
    assert tuple(out.shape) == (m, m)
    assert out.is_contiguous() and out.stride() == (m, 1)
    (src,) = [c.cell_contents for c in calls["transpose_2d"].__closure__]
    assert torch.equal(out, src.t())


def test_cases_compute_their_functions(cases):
    """The eager cases and the hand-written kernels' cases (their plain
    versions on the CPU) against numpy."""
    calls = {w.name: call for w, call in cases}
    n = microbench.QUICK.vector_n
    x = np.arange(n, dtype=np.float32)
    np.testing.assert_array_equal(calls["vec_copy"]().numpy(), x)
    np.testing.assert_array_equal(calls["vec_add"]().numpy(), x + 1.0)
    assert calls["reduction"]().item() == pytest.approx(
        x.sum(dtype=np.float64), rel=1e-6)
    matmul_kernel.launches = rmsnorm_kernel.launches = 0
    assert tuple(calls["gemm_kernel_256"]().shape) == (256, 256)
    assert tuple(calls["rmsnorm_kernel"]().shape) == (
        microbench.QUICK.rmsnorm_rows, microbench.QUICK.rmsnorm_d)
    assert matmul_kernel.launches == rmsnorm_kernel.launches == 0


def test_measured_suite_crosses_into_the_reference(cases):
    ws = [w for w, _ in cases]
    suite = microbench.MeasuredSuite(name="device_suite", workloads=ws,
                                     measured_s=[1e-3 * (i + 1)
                                                 for i in range(len(ws))],
                                     meta={"quick": 1.0})
    d = json.loads(json.dumps(suite.to_dict()))
    ref = ref_microbench.MeasuredSuite.from_dict(d)
    assert ref.name == suite.name and ref.meta == suite.meta
    assert ref.measured_s == suite.measured_s
    assert [w.to_dict() for w in ref.workloads] == [w.to_dict() for w in ws]
    back = microbench.MeasuredSuite.from_dict(ref.to_dict())
    assert back.to_dict() == suite.to_dict()
    with pytest.raises(ValueError, match="workloads"):
        microbench.MeasuredSuite(name="x", workloads=ws, measured_s=[1.0])


def test_ladder_is_the_reference_ladder(cases):
    """The port's calibration ladder on a suite with known times against the
    reference's ``table_cpuhost`` steps on the same data."""
    ws = [w for w, _ in cases]
    base = hardware.get("h100")
    hw = base.with_updates(name="h100_ladder_test",
                           tensor_sustained_flops={"fp32": 4.0e13},
                           hbm_sustained_bw=2.5e12, launch_latency_s=1e-5)
    model_s = np.array([r.model_s for r in port_core_validate.validate_suite(
        hw, ws, [1.0] * len(ws)).rows])
    rng = np.random.default_rng(0)
    meas = [float(t) for t in rng.uniform(0.5, 2.0, len(ws)) * model_s]
    suite = microbench.MeasuredSuite(name="device_suite", workloads=ws,
                                     measured_s=meas)
    lad = port_validate.ladder(hw, suite, base)

    ref_ws = [RefWorkload.from_dict(w.to_dict()) for w in ws]
    ref_hw = ref_hardware.get("h100").with_updates(
        name="h100_ladder_test", tensor_sustained_flops={"fp32": 4.0e13},
        hbm_sustained_bw=2.5e12, launch_latency_s=1e-5)
    rep = ref_validate.validate_suite(ref_hw, ref_ws, meas)
    rep_base = ref_validate.validate_suite(ref_hardware.get("h100"), ref_ws,
                                           meas)

    def pf(w):
        return ref_sweep.default_engine().predict(w, ref_hw)
    _, cal_report = ref_calibrate.fit_with_holdout(ref_ws, meas, pf,
                                                   mode="class")
    cal_p = ref_calibrate.fit_per_case(ref_ws, meas, pf)
    repp = ref_validate.validate_suite(ref_hw, ref_ws, meas,
                                       calibration=cal_p)
    maes = lad.maes()
    assert maes["uncalibrated_measured"] == {"model": rep.model_mae,
                                             "roofline": rep.roofline_mae}
    assert maes["uncalibrated_base"] == {"model": rep_base.model_mae,
                                         "roofline": rep_base.roofline_mae}
    assert maes["class_calibrated_holdout"]["model"] == \
        cal_report["holdout_mae"]
    assert maes["per_case"]["model"] == repp.model_mae
    assert maes["per_case"]["model"] < 1e-9
    rows = lad.rows()
    assert [r["kernel"] for r in rows] == [w.name for w in ws]
    for row, r in zip(rows, rep.rows):
        assert row["model_err_pct"] == round(r.model_err, 1)
        assert row["roofline_err_pct"] == round(r.roofline_err, 1)
    assert "class-cal holdout" in lad.derived()


def test_the_loop_runs_end_to_end_on_the_cpu():
    """``python -m repro_torch.launch.validate --quick --device cpu``: the
    whole loop (calibrate_device, device_suite, the ladder) at the quick
    sizes.  The only test that compiles and times."""
    buf = io.StringIO()
    with redirect_stdout(buf):
        assert port_validate.main(["--quick", "--device", "cpu"]) == 0
    lines = buf.getvalue().strip().splitlines()
    rows = [json.loads(line) for line in lines[:-1]]
    assert [r["kernel"] for r in rows] == [
        "vec_copy", "vec_add", "reduction", "transpose_2d", "rmsnorm_kernel",
        "gemm_256", "gemm_512", "gemm_kernel_256", "poly_chain",
        "hotspot_like_stencil"]
    for r in rows:
        assert r["measured_us"] > 0 and np.isfinite(r["model_us"])
    assert lines[-1].startswith("REAL measurements on cpu_host_measured")
    hw = hardware.get("cpu_host_measured")
    assert hw.launch_latency_s > 0 and hw.hbm_sustained_bw > 0
    assert hw.working_set_scale_bytes == 0.0
    assert hw.model_family == hardware.get("cpu_host").model_family


def test_compiled_raises_instead_of_falling_back():
    def breaks(v):
        torch._dynamo.graph_break()
        return v + 1.0
    with pytest.raises(Exception):
        microbench.compiled(breaks)(torch.ones(4))


def test_full_fp32_products_restores_the_flags():
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with microbench.full_fp32_products():
            assert not torch.backends.cuda.matmul.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert torch.backends.cuda.matmul.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False


@pytest.mark.parametrize("entry", [
    lambda: microbench.calibrate_device(),
    lambda: microbench.device_suite(),
    lambda: microbench.device_suite_result(),
    lambda: microbench.suite_cases(),
    lambda: microbench.measure_matmul_flops(64),
    lambda: microbench.measure_stream_bandwidth(1 << 10),
    lambda: microbench.measure_launch_latency(),
    lambda: microbench.measure_vector_flops(64),
    lambda: microbench.base_params(),
    lambda: port_validate.table_device(),
], ids=["calibrate_device", "device_suite", "device_suite_result",
        "suite_cases", "measure_matmul_flops", "measure_stream_bandwidth",
        "measure_launch_latency", "measure_vector_flops", "base_params",
        "table_device"])
def test_entry_points_raise_without_a_card(entry):
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="CUDA"):
        entry()


def test_another_card_is_never_priced_as_an_h100(monkeypatch):
    monkeypatch.setattr(microbench, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(RuntimeError, match="A100"):
        microbench.base_params()


class _Props:
    def __init__(self, sms):
        self.multi_processor_count = sms


@pytest.mark.parametrize("name,sms,error", [
    ("NVIDIA H100 80GB HBM3", 132, None),       # the SXM5 card h100.json is
    ("NVIDIA H100 PCIe", 114, "H100 PCIe"),
    ("NVIDIA H100 NVL", 132, "H100 NVL"),
    ("NVIDIA H100 80GB HBM3", 114, "114 SMs"),  # a cut-down part, same name
], ids=["sxm5", "pcie", "nvl", "sxm5-name-other-sm-count"])
def test_only_the_sxm5_h100_is_priced_with_h100_json(monkeypatch, name, sms,
                                                     error):
    monkeypatch.setattr(microbench, "resolve_device",
                        lambda device=None: torch.device("cuda"))
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda device=None: name)
    monkeypatch.setattr(torch.cuda, "get_device_properties",
                        lambda device=None: _Props(sms))
    if error is None:
        assert microbench.base_params() is hardware.get("h100")
    else:
        with pytest.raises(RuntimeError, match=error):
            microbench.base_params()


def test_base_params_on_the_host_is_the_reference_placeholder():
    port, ref = microbench.base_params("cpu"), ref_hardware.get("cpu_host")
    assert port is hardware.get("cpu_host")
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
