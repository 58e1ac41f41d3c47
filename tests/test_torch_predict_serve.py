"""The port's prediction server (``repro_torch.serve``, ``repro_torch.obs.
trace``, ``repro_torch.launch.predict_serve``) against the reference's
``repro.serve`` on the CPU.

The port's serve stack is a copy of the reference's: the same source but
for module paths, the same bytes on the wire, and each package's client
talks to the other's server with answers bit-identical to the in-process
sweep.  Servers run in-process on ephemeral ports; every client call has a
deadline; no test sleeps to wait for a state; every subprocess is stopped in
a ``finally``.
"""
import http.client
import re
import selectors
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import calibrate as ref_calibrate  # noqa: E402
from repro.core import hardware as ref_hardware  # noqa: E402
from repro.core import hwlib as ref_hwlib  # noqa: E402
from repro.core import microbench as ref_microbench  # noqa: E402
from repro.core import sweep as ref_sweep  # noqa: E402
from repro.core import workload as ref_workload  # noqa: E402
from repro.serve import chaos as ref_chaos  # noqa: E402
from repro.serve import client as ref_client  # noqa: E402
from repro.serve import codec as ref_codec  # noqa: E402
from repro.serve import errors as ref_errors  # noqa: E402
from repro.serve import server as ref_server  # noqa: E402
from repro_torch.core import calibrate, hardware, hwlib, microbench, \
    sweep, workload  # noqa: E402
from repro_torch.kernels.matmul import ops as mm_ops  # noqa: E402
from repro_torch.serve import chaos, client, codec, errors, \
    server  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SRC = ROOT / "src"
DEADLINE_S = 60.0

PKGS = {
    "reference": SimpleNamespace(
        hardware=ref_hardware, hwlib=ref_hwlib, sweep=ref_sweep,
        workload=ref_workload, calibrate=ref_calibrate, codec=ref_codec,
        errors=ref_errors, chaos=ref_chaos, Client=ref_client.PredictionClient,
        Server=ref_server.PredictionServer,
        MeasuredSuite=ref_microbench.MeasuredSuite),
    "port": SimpleNamespace(
        hardware=hardware, hwlib=hwlib, sweep=sweep, workload=workload,
        calibrate=calibrate, codec=codec, errors=errors, chaos=chaos,
        Client=client.PredictionClient, Server=server.PredictionServer,
        MeasuredSuite=microbench.MeasuredSuite),
}

# The reference's serve stack and the modules it brings along, as paths
# below src/repro (the port's copy sits at the same path below
# src/repro_torch).
COPIED = ("serve/__init__.py", "serve/errors.py", "serve/codec.py",
          "serve/framing.py", "serve/server.py", "serve/binserver.py",
          "serve/client.py", "serve/chaos.py", "serve/subproc.py",
          "serve/README.md", "obs/trace.py", "launch/predict_serve.py")
# Differences beyond the module paths in docstrings, comments and help
# text: (file, port text, reference text).
CHANGED = {
    "serve/subproc.py": [('args = [sys.executable, "-m", '
                          '"repro_torch.serve.server"',
                          'args = [sys.executable, "-m", '
                          '"repro.serve.server"')],
    "serve/README.md": [("src/repro_torch/core/hwdata/",
                         "src/repro/core/hwdata/")],
    # spans start on the profiler's clock, carry ids and, for compute
    # spans (obs/compute.py), a device interval; the ring holds a traced
    # window
    "obs/trace.py": [
        ('Spans are lightweight completed-interval records (start, duration,\n'
         "small attribute dict, their own id and their parent's) kept in a bounded\n"
         'process-global ring so tests and the demo can ask "which spans did trace\n'
         'X produce?" without an external collector.  Recording honours the\n'
         'metrics kill switch (``metrics.set_enabled(False)`` silences spans too).\n'
         '\n'
         "A span starts on ``time.time_ns()``, the clock of ``torch.profiler``'s\n"
         'events, so it lays over a profiler trace as it stands; its duration is\n'
         "taken on ``time.perf_counter_ns()``.  The ring also holds the model's\n"
         'compute spans (:mod:`.compute`): a prefill or a training step and its\n'
         'layers, recorded only while a ``torch.profiler`` trace is being taken,\n'
         'on the same clock, each with the interval its work took on the device.\n',
         'Spans are lightweight completed-interval records (monotonic start,\n'
         'duration, small attribute dict) kept in a bounded process-global ring\n'
         'so tests and the demo can ask "which spans did trace X produce?"\n'
         'without an external collector.  Recording honours the metrics kill\n'
         'switch (``metrics.set_enabled(False)`` silences spans too).\n'),
        ('\n'
         'import itertools\n',
         '\n'),
        ('    start_ns: int           # time.time_ns() at entry\n'
         '    duration_s: float\n'
         '    attrs: Dict\n'
         '    span_id: int = 0\n'
         '    parent_id: int = 0      # the span that opened this one; 0 for a root\n'
         '    device: Optional[object] = None     # compute spans: its seconds there\n'
         '\n'
         '    @property\n'
         '    def start_s(self) -> float:\n'
         '        return self.start_ns / 1e9\n'
         '\n'
         '    @property\n'
         '    def end_ns(self) -> int:\n'
         '        return self.start_ns + round(self.duration_s * 1e9)\n'
         '\n'
         '    @property\n'
         '    def device_s(self) -> Optional[float]:\n'
         '        """Seconds on the device (compute spans only)."""\n'
         '        return None if self.device is None else self.device.seconds\n',
         '    start_s: float          # time.monotonic() at entry\n'
         '    duration_s: float\n'
         '    attrs: Dict\n'),
        ('\n'
         '#: a traced window holds ~100 requests of ~100 compute spans each\n'
         '_SPANS_MAX = 1 << 16\n',
         '\n'
         '_SPANS_MAX = 4096\n'),
        ('_IDS = itertools.count(1)\n',
         ""),
        ('        start_s = time.time_ns() / 1e9 - duration_s\n'
         '    sp = Span(name, trace_id, round(start_s * 1e9), duration_s, attrs,\n'
         '              next(_IDS))\n',
         '        start_s = time.monotonic() - duration_s\n'
         '    sp = Span(name, trace_id, start_s, duration_s, attrs)\n'),
        ('    t0, c0 = time.time_ns(), time.perf_counter_ns()\n',
         '    t0 = time.monotonic()\n'),
        ('        record_span(name, trace_id, (time.perf_counter_ns() - c0) / 1e9,\n'
         '                    start_s=t0 / 1e9, **attrs)\n',
         '        record_span(name, trace_id, time.monotonic() - t0,\n'
         '                    start_s=t0, **attrs)\n'),
    ],
}
MODULE_PATH = re.compile(r"\brepro_torch\.(serve|obs|core|launch)\b")


# --------------------------------------------------------------- the copies

def test_every_reference_serve_module_has_its_port():
    ref = {str(p.relative_to(SRC / "repro"))
           for p in (SRC / "repro" / "serve").iterdir() if p.is_file()}
    assert ref | {"obs/trace.py", "launch/predict_serve.py"} == set(COPIED)
    for rel in COPIED:
        assert (SRC / "repro_torch" / rel).is_file(), rel
    from repro_torch import obs
    assert obs.__all__ == ["metrics", "trace"]


@pytest.mark.parametrize("rel", COPIED)
def test_copy_is_the_reference_but_for_module_paths(rel):
    port = (SRC / "repro_torch" / rel).read_text()
    ref = (SRC / "repro" / rel).read_text()
    for port_text, ref_text in CHANGED.get(rel, ()):
        assert port_text in port
        port = port.replace(port_text, ref_text)
    assert MODULE_PATH.sub(r"repro.\1", port) == ref


@pytest.mark.parametrize("rel", [r for r in COPIED if r.endswith(".py")])
def test_copy_imports_neither_jax_nor_the_reference_nor_torch(rel):
    text = (SRC / "repro_torch" / rel).read_text()
    assert not re.search(r"^\s*(import|from)\s+(jax|repro\b|torch)", text,
                         re.M), rel


# ----------------------------------------------------------------- the wire

TILES = [(bm, bn, bk) for bm in (64, 128, 256) for bn in (64, 128, 256)
         for bk in (16, 32, 64)]


def _table(pkg, m=4096, precision="bf16"):
    w = PKGS[pkg].workload
    return w.WorkloadTable.tile_lattice(
        w.gemm_workload("g", m, 4096, 2048, precision=precision),
        [w.TileConfig(*t) for t in TILES])


def _spec(pkg):
    w = PKGS[pkg].workload
    grid = np.geomspace(1e6, 1e12, 40)
    return w.LatticeSpec.cartesian(
        w.gemm_workload("l", 2048, 2048, 2048, precision="fp16"),
        flops=grid, bytes=grid)


@pytest.fixture(scope="module")
def port_suite():
    """The port's quick measured suite on the CPU (host times)."""
    return microbench.device_suite_result(quick=True, device="cpu")


def _suite(pkg, port_suite):
    return PKGS[pkg].MeasuredSuite.from_dict(port_suite.to_dict())


def _calibration(pkg):
    return PKGS[pkg].calibrate.Calibration.from_dict(
        {"per_case": {"gemm": 1.25}, "per_class": {"memory": 0.875},
         "global_scale": 1.0, "skipped": ["odd"]})


# kind -> (encode(pkg, suite) -> bytes, re-encode(pkg, bytes) -> bytes)
WIRE = {
    "table": (lambda p, s: PKGS[p].codec.encode_table(_table(p)),
              lambda p, b: PKGS[p].codec.encode_table(
                  PKGS[p].codec.decode_table(b))),
    "spec": (lambda p, s: PKGS[p].codec.encode_spec(_spec(p)),
             lambda p, b: PKGS[p].codec.encode_spec(
                 PKGS[p].codec.decode_spec(b))),
    "request": (lambda p, s: PKGS[p].codec.encode_request(
                    "topk", _table(p), hw="h100", k=3, trace_id="0" * 16),
                lambda p, b: _reencode_request(p, b)),
    "hardware_params": (
        lambda p, s: PKGS[p].codec.encode_hardware(
            PKGS[p].hardware.get("b200")),
        lambda p, b: PKGS[p].codec.encode_hardware(
            PKGS[p].codec.decode_hardware(b))),
    "hardware_entry": (
        lambda p, s: PKGS[p].codec.encode_hardware(PKGS[p].hwlib.load_file(
            PKGS[p].hwlib.library_file("h100"))),
        lambda p, b: PKGS[p].codec.encode_hardware(
            PKGS[p].codec.decode_hardware(b))),
    "calibration": (
        lambda p, s: PKGS[p].codec.encode_calibration(
            _calibration(p), {"holdout_mae": 12.5}),
        lambda p, b: PKGS[p].codec.encode_calibration(
            *PKGS[p].codec.decode_calibration(b))),
    "suite": (lambda p, s: PKGS[p].codec.encode_suite(_suite(p, s)),
              lambda p, b: PKGS[p].codec.encode_suite(
                  PKGS[p].codec.decode_suite(b))),
    "calibrate_request": (
        lambda p, s: PKGS[p].codec.encode_calibrate_request(
            _suite(p, s), hw="h100", mode="case", register_as="x"),
        lambda p, b: _reencode_calibrate_request(p, b)),
    "winners": (
        lambda p, s: PKGS[p].codec.encode_winners(
            PKGS[p].sweep.topk_table(_table(p), PKGS[p].hardware.get("h100"),
                                     4)),
        lambda p, b: PKGS[p].codec.encode_winners(
            PKGS[p].codec.decode_winners(b))),
    "totals": (
        lambda p, s: PKGS[p].codec.encode_totals(PKGS[p].sweep.predict_table(
            _table(p), PKGS[p].hardware.get("b200")).totals),
        lambda p, b: PKGS[p].codec.encode_totals(
            PKGS[p].codec.decode_totals(b))),
    "error": (lambda p, s: PKGS[p].codec.encode_error(
                  PKGS[p].errors.RateLimited("slow down", retry_after_s=0.5)),
              lambda p, b: PKGS[p].codec.encode_error(
                  PKGS[p].errors.RateLimited(
                      PKGS[p].codec.decode_error(b)[1],
                      retry_after_s=PKGS[p].codec.decode_error(b)[2]))),
}


def _reencode_request(pkg, data):
    c = PKGS[pkg].codec
    op, source, meta = c.decode_request(data)
    return c.encode_request(
        op, source, hw=meta["hw"], model=meta["model"], k=meta["k"],
        objectives=meta["objectives"], chunk_size=meta["chunk_size"],
        jobs=meta["jobs"], coalesce=meta["coalesce"],
        trace_id=meta.get("trace_id"))


def _reencode_calibrate_request(pkg, data):
    c = PKGS[pkg].codec
    suite, meta = c.decode_calibrate_request(data)
    return c.encode_calibrate_request(
        suite, hw=meta["hw"], mode=meta["mode"],
        holdout_fraction=meta["holdout_fraction"], seed=meta["seed"],
        model=meta["model"], register_as=meta["register_as"])


@pytest.mark.parametrize("kind", WIRE)
def test_both_packages_put_the_same_bytes_on_the_wire(kind, port_suite):
    encode, reencode = WIRE[kind]
    ref_bytes = encode("reference", port_suite)
    port_bytes = encode("port", port_suite)
    assert port_bytes == ref_bytes
    # each package decodes the other's bytes to what it encodes again
    assert reencode("port", ref_bytes) == ref_bytes
    assert reencode("reference", port_bytes) == port_bytes


def test_wire_constants_are_the_reference_s():
    assert codec.WIRE_VERSION == ref_codec.WIRE_VERSION
    assert codec.MAGIC == ref_codec.MAGIC
    assert server.CONTENT_TYPE == ref_server.CONTENT_TYPE


# ----------------------------------------------- clients and servers crossed

@pytest.fixture(scope="module")
def servers():
    started = {}
    try:
        for pkg in PKGS:
            started[pkg] = PKGS[pkg].Server(port=0, binary_port=0).start()
        yield started
    finally:
        for srv in started.values():
            srv.shutdown()


def _client(pkg, srv, transport):
    return PKGS[pkg].Client(*srv.address, transport=transport,
                            binary_port=srv.binary_address[1],
                            timeout=30.0)


def _ask(pkg, cli, op, table, hw):
    if op == "predict_totals":
        return cli.predict_totals(table, hw, deadline_s=DEADLINE_S)
    if op == "argmin":
        return [cli.argmin(table, hw, deadline_s=DEADLINE_S)]
    if op == "topk":
        return cli.topk(table, hw, 5, deadline_s=DEADLINE_S)
    return cli.pareto(table, hw, deadline_s=DEADLINE_S)


def _in_process(pkg, op, table, hw):
    sw, params = PKGS[pkg].sweep, PKGS[pkg].hardware.get(hw)
    engine = sw.SweepEngine(use_cache=False)
    if op == "predict_totals":
        return sw.predict_table(table, params, engine=engine).totals
    if op == "argmin":
        return [sw.argmin_table(table, params, engine=engine)]
    if op == "topk":
        return sw.topk_table(table, params, 5, engine=engine)
    return sw.pareto_table(table, params, engine=engine)


def _wire_form(pkg, op, answer):
    c = PKGS[pkg].codec
    if op == "predict_totals":
        return c.encode_totals(answer)
    return c.encode_winners(answer)


@pytest.mark.parametrize("op", ["predict_totals", "argmin", "topk",
                                "pareto"])
@pytest.mark.parametrize("hw", ["h100", "b200"])
@pytest.mark.parametrize("transport", ["http", "binary"])
@pytest.mark.parametrize("client_pkg,server_pkg",
                         [("reference", "port"), ("port", "reference")],
                         ids=["ref_client-port_server",
                              "port_client-ref_server"])
def test_crossed_pairs_answer_as_the_in_process_sweep(
        servers, client_pkg, server_pkg, transport, hw, op):
    m = 1024 + 512 * len(op) + len(hw)       # another table for each case
    table = _table(client_pkg, m=m)
    with _client(client_pkg, servers[server_pkg], transport) as cli:
        got = _ask(client_pkg, cli, op, table, hw)
    want = _in_process(client_pkg, op, table, hw)
    if op == "predict_totals":
        assert got.dtype == want.dtype and np.array_equal(got, want)
    else:
        assert len(got) == len(want) > 0
    # bit for bit: the same bytes once encoded, and the same as what the
    # other package computes in process
    assert _wire_form(client_pkg, op, got) == _wire_form(client_pkg, op,
                                                         want)
    other = _in_process(server_pkg, op, _table(server_pkg, m=m), hw)
    assert _wire_form(server_pkg, op, other) == _wire_form(client_pkg, op,
                                                           want)


def test_streamed_lattice_plan_crosses_bit_identically(servers):
    """A lazy lattice plan from the reference client, priced by the port
    server chunk by chunk, against the in-process sweep."""
    spec = _spec("reference")
    want = ref_sweep.predict_table(spec.materialize(),
                                   ref_hardware.get("h100")).totals
    with _client("reference", servers["port"], "binary") as cli:
        got = cli.predict_totals(spec, "h100", chunk_size=512,
                                 deadline_s=DEADLINE_S)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("precision", ["fp32", "bf16"])
def test_served_tile_is_select_blocks_pick(servers, precision):
    """What chip_smoke.py's predict_serve phase checks on the card: the
    served argmin over the matmul kernel's instantiated tiles is
    ``select_blocks``' pick at its cost, bit for bit, on both transports."""
    blocks = mm_ops.kernel_blocks(precision)
    for m, n, k in ((4096, 4096, 4096), (8192, 2560, 6912)):
        table = workload.WorkloadTable.tile_lattice(
            workload.gemm_workload(f"matmul_{m}x{n}x{k}", m, n, k,
                                   precision=precision),
            [workload.TileConfig(*b) for b in blocks])
        pick, costs = mm_ops.select_blocks(m, n, k, precision=precision)
        for transport in ("http", "binary"):
            with _client("port", servers["port"], transport) as cli:
                win = cli.argmin(table, "h100", deadline_s=DEADLINE_S)
            assert blocks[win.index] == pick
            assert win.total == costs[pick]


def test_worker_pool_is_a_forkserver_that_prices_bit_identically():
    """``--jobs 2`` in a process that has loaded torch (this one): the pool
    forks nothing and is a forkserver whose workers re-import the port's
    core (not torch: ``core.microbench`` loads lazily).  Its first streamed
    request carries the pool's start (printed, host clock); both requests
    match the in-process sweep."""
    from repro_torch.core import parallel
    assert parallel._mp_context().get_start_method() == "forkserver"
    secs = []
    with server.PredictionServer(port=0, jobs=2).start() as srv:
        assert srv.pool is not None
        with client.PredictionClient(*srv.address, timeout=120.0) as cli:
            for scale in (1.0, 1.5):     # another lattice: no cache answers
                spec = workload.LatticeSpec.cartesian(
                    workload.gemm_workload("p", 2048, 2048, 2048,
                                           precision="bf16"),
                    flops=np.geomspace(1e6, 1e12, 40) * scale,
                    bytes=np.geomspace(1e6, 1e12, 40))
                t0 = time.perf_counter()
                got = cli.predict_totals(spec, "h100", jobs=2, chunk_size=400,
                                         deadline_s=300.0)
                secs.append(time.perf_counter() - t0)
                want = sweep.predict_table(spec.materialize(),
                                           hardware.get("h100")).totals
                assert np.array_equal(got, want)
    print(f"[pool] first pooled request {secs[0]:.3f} s (the pool's start), "
          f"second {secs[1]:.3f} s")


_FORKED_POOL = """
import sys
import numpy as np
from repro_torch.core import hardware, parallel, sweep, workload
from repro_torch.serve import client, server
assert parallel._mp_context().get_start_method() == "fork"
spec = workload.LatticeSpec.cartesian(
    workload.gemm_workload("p", 2048, 2048, 2048, precision="bf16"),
    flops=np.geomspace(1e6, 1e12, 40), bytes=np.geomspace(1e6, 1e12, 40))
want = sweep.predict_table(spec.materialize(), hardware.get("h100")).totals
# a per-call pool, forked: this process is single-threaded and has no torch
assert parallel.processes_available()
got = sweep.predict_totals_stream(spec, hardware.get("h100"), jobs=2,
                                  chunk_size=400)
assert np.array_equal(got, want)
with server.PredictionServer(port=0, jobs=2).start() as srv:
    with client.PredictionClient(*srv.address, timeout=120.0) as cli:
        got = cli.predict_totals(spec, "h100", jobs=2, chunk_size=400,
                                 deadline_s=300.0)
assert np.array_equal(got, want)
assert "torch" not in sys.modules
print("ok")
"""


def test_pool_prices_bit_identically_in_a_process_without_torch(tmp_path):
    """Where no torch is loaded (the server's own process) the port's pools
    start as the reference's do: a per-call pool of a single-threaded
    process forks, and the server's ``--jobs 2`` pool is a forkserver whose
    workers import no torch either; both price the lattice bit-identically
    to the in-process sweep."""
    env = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", _FORKED_POOL], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip() == "ok"


_LAZY_MICROBENCH = """
import sys
import repro_torch.serve.server, repro_torch.launch.predict_serve
import repro_torch.core as core
assert "torch" not in sys.modules, "importing the server loaded torch"
assert "microbench" in core.__all__
assert "repro_torch.core.microbench" not in sys.modules
bench = core.microbench
assert "torch" in sys.modules and bench.MeasuredSuite
print("ok")
"""


def test_importing_the_server_loads_no_torch(tmp_path):
    """A fresh interpreter that imports the server and its launcher holds no
    torch; ``repro_torch.core.microbench`` stays an attribute of the
    package, and loading it is what brings torch in."""
    env = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path)}
    out = subprocess.run([sys.executable, "-c", _LAZY_MICROBENCH], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.strip() == "ok"


# --------------------------------------------------------------- calibration

@pytest.mark.parametrize("mode", ["class", "case"])
def test_served_calibration_is_the_reference_server_s(servers, port_suite,
                                                      mode):
    """/v1/calibrate on the port server fits what the reference server fits
    on the same suite and seed, and what the port fits in process."""
    fits = {}
    for pkg in PKGS:
        with PKGS[pkg].Client(*servers[pkg].address, timeout=30.0) as cli:
            cal, report = cli.calibrate(_suite(pkg, port_suite), "h100",
                                        mode=mode, seed=3,
                                        deadline_s=DEADLINE_S)
        fits[pkg] = (cal.to_dict(), report)
    engine = sweep.SweepEngine()
    local_cal, local_report = calibrate.fit_with_holdout(
        port_suite.workloads, port_suite.measured_s,
        lambda w: engine.predict(w, hardware.get("h100")), mode=mode, seed=3)
    assert fits["port"] == fits["reference"]
    assert fits["port"] == (local_cal.to_dict(), local_report)
    assert local_cal.per_class or local_cal.per_case


def test_registered_parameters_read_back_and_price(servers):
    """POST /v1/hardware then GET gives the registered parameters back,
    and sweeps price on them (as the card path registers h100_measured)."""
    import dataclasses
    params = dataclasses.replace(hardware.get("h100"),
                                 name="h100_serve_test",
                                 hbm_sustained_bw=2.5e12)
    with _client("port", servers["port"], "http") as cli:
        try:
            cli.hardware_register(params, deadline_s=DEADLINE_S)
            assert cli.hardware_get("h100_serve_test",
                                    deadline_s=DEADLINE_S).params == params
            got = cli.predict_totals(_table("port"), "h100_serve_test",
                                     deadline_s=DEADLINE_S)
        finally:
            cli.hardware_delete("h100_serve_test", deadline_s=DEADLINE_S)
    want = sweep.predict_table(_table("port"), params).totals
    assert np.array_equal(got, want)


# ---------------------------------------------- status codes and typed faults

SCHEDULE_SEED = 17
SCHEDULE_KINDS = ("pass", "delay", "truncate", "sever")


def _raw(address, method, path, body=b"", headers=None):
    conn = http.client.HTTPConnection(*address, timeout=10.0)
    try:
        conn.request(method, path, body=body, headers={
            "Content-Length": str(len(body)), **(headers or {})})
        resp = conn.getresponse()
        resp.read()
        return resp.status, resp.getheader("Retry-After") is not None
    finally:
        conn.close()


def _typed(call):
    try:
        call()
    except Exception as e:  # noqa: BLE001 — the class is the result
        cause = type(e.__cause__).__name__ if e.__cause__ else None
        return type(e).__name__, cause
    return "ok", None


def _fault_outcomes(pkg):
    """401, 429 + Retry-After, 503 + Retry-After and deadlines, first as
    raw HTTP statuses, then as the client's typed errors through a chaos
    proxy on a seeded schedule."""
    p = PKGS[pkg]
    out = []
    table = _table(pkg)
    argmin = p.codec.encode_request("argmin", table, hw="b200")
    wire = {"Content-Type": "application/x-repro-wire"}
    with p.Server(port=0, auth_token="tok", mutate_rps=0.01, mutate_burst=1,
                  max_queue_depth=0).start() as srv:
        out.append(_raw(srv.address, "POST", "/v1/clear_cache"))
        out.append(_raw(srv.address, "POST", "/v1/clear_cache",
                        headers={p.errors.AUTH_HEADER: "tok"}))
        out.append(_raw(srv.address, "POST", "/v1/clear_cache",
                        headers={p.errors.AUTH_HEADER: "tok"}))
        out.append(_raw(srv.address, "POST", "/v1/argmin", argmin, wire))
        out.append(_raw(srv.address, "POST", "/v1/argmin", argmin,
                        {**wire, p.errors.DEADLINE_HEADER: "-0.5"}))
        schedule = p.chaos.seeded_schedule(SCHEDULE_SEED, 4,
                                           kinds=SCHEDULE_KINDS)
        with p.chaos.ChaosProxy(*srv.address, schedule) as px:
            kw = dict(timeout=5.0, connect_timeout=3.0, backoff_base_s=0.01,
                      max_retries=6)
            with p.Client(*px.address, **kw) as anon:
                out.append(_typed(lambda: anon.clear_cache(
                    deadline_s=DEADLINE_S)))
            with p.Client(*px.address, auth_token="tok", **kw) as good:
                # the bucket is empty and refills in ~100 s: the 429's
                # Retry-After outlasts a 5 s deadline
                out.append(_typed(lambda: good.clear_cache(deadline_s=5.0)))
            with p.Client(*px.address, **dict(kw, max_retries=2)) as c:
                out.append(_typed(lambda: c.argmin(table, "b200",
                                                   deadline_s=DEADLINE_S)))
                win = c.argmin(table, "b200", coalesce=False,
                               deadline_s=DEADLINE_S)
                out.append(("uncoalesced", win.index))
            out.append(("schedule", [f.kind for f in px.connection_log[:4]]))
        with p.chaos.ChaosProxy(*srv.address, [],
                                default=p.chaos.FaultSpec("stall")) as px:
            with p.Client(*px.address, timeout=30.0, max_retries=5) as c:
                t0 = time.monotonic()
                out.append(_typed(lambda: c.argmin(table, "b200",
                                                   deadline_s=1.0)))
                out.append(("bounded", time.monotonic() - t0 < 5.0))
    return out


@pytest.fixture(scope="module")
def reference_faults():
    return _fault_outcomes("reference")


def test_status_codes_and_typed_faults_match_the_reference(
        reference_faults):
    got = _fault_outcomes("port")
    assert got == reference_faults
    best = ref_sweep.argmin_table(_table("reference"),
                                  ref_hardware.get("b200")).index
    # (status, Retry-After sent): the expired deadline is shed without one
    assert got[:5] == [(401, False), (200, False), (429, True), (503, True),
                       (503, False)]
    assert got[5:9] == [("Unauthorized", None),
                        ("DeadlineExceeded", "RateLimited"),
                        ("ServerOverloaded", None), ("uncoalesced", best)]
    assert got[10:] == [("DeadlineExceeded", None), ("bounded", True)]


# --------------------------------------------------------------- the launcher

def test_predict_serve_launcher_subprocess_imports_no_jax(tmp_path):
    """``python -m repro_torch.launch.predict_serve serve --port 0``: its
    banner, its health, and every module it imported (``-X importtime``
    lists each one as it is imported)."""
    imports = tmp_path / "imports.txt"
    env = {"PYTHONPATH": str(SRC), "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path)}
    with open(imports, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, "-X", "importtime", "-m",
             "repro_torch.launch.predict_serve", "serve", "--port", "0"],
            stdout=subprocess.PIPE, stderr=err, text=True, env=env,
            start_new_session=True)
    try:
        sel = selectors.DefaultSelector()
        sel.register(proc.stdout, selectors.EVENT_READ)
        assert sel.select(timeout=120.0), "no banner within 120 s"
        banner = proc.stdout.readline()
        sel.close()
        match = re.fullmatch(r"\[serve\] listening on http://(.+):(\d+)\n",
                             banner)
        assert match, banner
        with client.PredictionClient(match[1], int(match[2]),
                                     transport="http") as cli:
            health = cli.health(deadline_s=DEADLINE_S)
        assert health["status"] == "ok" and "h100" in health["hardware"]
    finally:
        from repro_torch.serve import subproc
        subproc.stop_server_subprocess(proc)
        proc.stdout.close()
    names = {line.rsplit("|", 1)[1].strip()
             for line in imports.read_text().splitlines()
             if line.startswith("import time:") and "|" in line}
    # (the launcher itself runs as __main__, so its package stands for it)
    assert {"repro_torch.launch", "repro_torch.serve.server",
            "repro_torch.serve.codec", "repro_torch.obs.trace"} <= names
    assert not [n for n in names
                if n == "jax" or n.startswith(("jax.", "repro."))
                or n == "repro"]
    assert not [n for n in names if n == "torch" or n.startswith("torch.")]
