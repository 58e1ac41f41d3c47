"""The port's contract linter (``repro_torch.analysis``) against the
reference's (``repro.analysis``) on the CPU.

The port's linter is the reference's with its path constants pointed at
``src/repro_torch``.  Every fixture case of ``tests/test_contracts.py``
runs here through both linters on the same fixture source: the reference's
on the reference's paths, the port's on the port's (``src/repro/`` ->
``src/repro_torch/``, ``tests/test_obs.py`` -> ``tests/test_torch_obs.py``),
and both give the same findings (rule, path, line, severity, suppressed).
Then the port itself lints clean, the gate ``python -m repro_torch.analysis``
passes on it and fails a copy of it that breaks any one of the six rules,
the port's wire lock is the reference's, and importing the linter loads
neither torch nor the reference.
"""
import json
import os
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

import repro.analysis as ref_analysis
import repro_torch.analysis as port_analysis
from repro.analysis.rules import wire_drift as ref_wire
from repro_torch.analysis import __main__ as gate
from repro_torch.analysis.rules import wire_drift as port_wire

ROOT = Path(__file__).resolve().parents[1]
PORT_PATHS = (("src/repro/", "src/repro_torch/"),
              ("tests/test_obs.py", "tests/test_torch_obs.py"))


class Side:
    """One linter and the paths its rules name."""

    def __init__(self, analysis, wire, port: bool):
        self.analysis, self.wire, self.port = analysis, wire, port

    def rel(self, ref_rel: str) -> str:
        if self.port:
            for a, b in PORT_PATHS:
                if ref_rel.startswith(a):
                    return b + ref_rel[len(a):]
        return ref_rel

    def unrel(self, rel: str) -> str:
        if self.port:
            for a, b in PORT_PATHS:
                if rel.startswith(b):
                    return a + rel[len(b):]
        return rel

    def lint(self, root, files, rules, baseline=None):
        """Write ``{reference rel: source}`` under ``root`` at this side's
        paths and lint those files (``tests/test_contracts.py``'s
        ``lint``)."""
        rels = []
        for rel, src in files.items():
            p = root / self.rel(rel)
            p.parent.mkdir(parents=True, exist_ok=True)
            p.write_text(textwrap.dedent(src))
            rels.append(self.rel(rel))
        return self.analysis.run_checks(root=str(root), paths=sorted(rels),
                                        rules=rules, baseline=baseline)

    def copy_wire_files(self, root):
        for rel in (self.wire.CODEC_REL, self.wire.FRAMING_REL,
                    self.wire.LOCK_REL):
            dst = root / rel
            dst.parent.mkdir(parents=True, exist_ok=True)
            dst.write_text((ROOT / rel).read_text())

    def wire_run(self, root):
        return self.analysis.run_checks(
            root=str(root), paths=[self.rel("src/repro/serve")],
            rules=["WIRE-DRIFT"])

    def edit(self, root, which, old, new):
        path = root / getattr(self.wire, which)
        text = path.read_text()
        assert old in text
        path.write_text(text.replace(old, new))


REF = Side(ref_analysis, ref_wire, port=False)
PORT = Side(port_analysis, port_wire, port=True)


# ---------------------------------------------------------------------------
# The fixture cases of tests/test_contracts.py, each written once for both
# sides: ``case(side, root)`` returns the reports it makes.
# ---------------------------------------------------------------------------

def sweep_fires(side, root):
    return [side.lint(root, {"src/repro/core/bad.py": """\
        def sweep(cfgs, hw):
            out = []
            for c in cfgs:
                out.append(predict(Workload(c), hw))
            totals = [predict(w, hw) for w in out]
            return totals
        """}, rules=["SWEEP-LOOP"])]


def sweep_quiet(side, root):
    return [side.lint(root, {
        "src/repro/core/ok.py": """\
            def one_off(cfg, hw):
                return predict(Workload(cfg), hw)
            """,
        "src/repro/core/suites/inventory.py": """\
            KERNELS = [Workload(c) for c in NAMED_CASES]
            """,
    }, rules=["SWEEP-LOOP"])]


def frozen_fires(side, root):
    return [side.lint(root, {"src/repro/core/bad.py": """\
        def poke(table, buf):
            table.cols[0, 1] = 9.0
            table.precision_codes[0] += 1
            buf.setflags(write=True)
            table.cols.resize((2, 2))
            table.wclass_codes = None
        """}, rules=["FROZEN-MUT"])]


def frozen_quiet(side, root):
    return [side.lint(root, {"src/repro/core/ok.py": """\
        class Table:
            def __init__(self, cols):
                cols[0, 0] = 1.0          # local array, still building
                cols.flags.writeable = False
                cols.setflags(write=False)
                self.cols = cols          # constructor initializes
        """}, rules=["FROZEN-MUT"])]


def loop_fires(side, root):
    return [side.lint(root, {"src/repro/serve/binserver.py": """\
        import time

        class Frontend:
            def _loop(self):
                self._readable()

            def _readable(self):
                time.sleep(0.5)
                self.fut.result()
                self.sock.sendall(b"x")
        """}, rules=["LOOP-BLOCK"])]


def loop_quiet(side, root):
    return [side.lint(root, {"src/repro/serve/binserver.py": """\
        import time

        class Frontend:
            def _loop(self):
                self._handle()

            def _handle(self):
                self.fut.result(timeout=0.1)

                def on_done(res):      # runs on the coalescer thread
                    time.sleep(1)
                self.coalescer.submit_async(on_done)

            def admin_snapshot(self):  # not reachable from _loop
                time.sleep(1)
        """}, rules=["LOOP-BLOCK"])]


def loop_other_modules(side, root):
    return [side.lint(root, {"src/repro/serve/worker.py": """\
        import time

        def _loop():
            time.sleep(1)
        """}, rules=["LOOP-BLOCK"])]


def fork_fires(side, root):
    return [side.lint(root, {"src/repro/core/bad.py": """\
        import threading

        _LOCK = threading.Lock()

        class Registry:
            def __init__(self):
                self._lock = threading.RLock()

        REGISTRY = Registry()
        """}, rules=["FORK-LOCK"])]


def fork_quiet(side, root):
    return [side.lint(root, {
        "src/repro/core/hooked.py": """\
            import os, threading

            _LOCK = threading.Lock()

            def _reinit():
                global _LOCK
                _LOCK = threading.Lock()

            os.register_at_fork(after_in_child=_reinit)
            """,
        "src/repro/core/instances.py": """\
            import threading

            class Pool:
                def __init__(self):
                    self._lock = threading.Lock()

            def make_pool():
                return Pool()         # per-call, not module lifetime
            """,
    }, rules=["FORK-LOCK"])]


def metric_fires(side, root):
    return [side.lint(root, {"src/repro/serve/bad.py": """\
        from repro.obs import metrics

        A = metrics.counter("requests_total", "outside namespace")
        B = metrics.counter("repro_serve_x_total", "h", color="red")
        C = metrics.counter("repro_serve_y_total", "h",
                            transport="carrier")
        D = metrics.counter(FAMILY, "computed name")
        """}, rules=["METRIC-NAME"])]


def metric_cross_check(side, root):
    return [side.lint(root, {
        "src/repro/serve/mod.py": """\
            from repro.obs import metrics
            M = metrics.counter("repro_serve_new_total", "h",
                                transport="http")
            """,
        "tests/test_obs.py": """\
            EXPECTED_FAMILIES = [
                "repro_serve_new_total",
                "repro_serve_gone_total",
            ]
            """,
    }, rules=["METRIC-NAME"])]


def metric_new_family(side, root):
    return [side.lint(root, {
        "src/repro/serve/mod.py": """\
            from repro.obs import metrics
            M = metrics.counter("repro_serve_new_total", "h")
            """,
        "tests/test_obs.py": "EXPECTED_FAMILIES = []\n",
    }, rules=["METRIC-NAME"])]


def wire_quiet(side, root):
    side.copy_wire_files(root)
    return [side.wire_run(root)]


def wire_renumber(side, root):
    side.copy_wire_files(root)
    side.edit(root, "CODEC_REL", "MSG_TABLE = 1\n", "MSG_TABLE = 12\n")
    return [side.wire_run(root)]


def wire_removed(side, root):
    side.copy_wire_files(root)
    side.edit(root, "CODEC_REL", "MSG_CALREQ = 11\n", "")
    return [side.wire_run(root)]


def wire_repacked(side, root):
    side.copy_wire_files(root)
    side.edit(root, "FRAMING_REL", '"<4sBBHIQf"', '"<4sBBHIQd"')
    return [side.wire_run(root)]


def wire_additive_then_refreshed(side, root):
    side.copy_wire_files(root)
    codec = root / side.wire.CODEC_REL
    codec.write_text(codec.read_text() + "\nMSG_FUTURE = 12\n")
    before = side.wire_run(root)
    modules = side.analysis.core.collect_modules(
        str(root), [side.rel("src/repro/serve")])
    project = side.analysis.Project(str(root), modules)
    schema, _ = side.wire.extract_schema(project)
    side.wire.write_lock(str(root), schema)
    return [before, side.wire_run(root)]


def wire_missing_lock(side, root):
    side.copy_wire_files(root)
    (root / side.wire.LOCK_REL).unlink()
    return [side.wire_run(root)]


BAD_MUT = """\
    def poke(table):
        table.cols[0] = 1.0{comment}
"""


def suppress_justified(side, root):
    return [side.lint(root, {"src/repro/core/bad.py": BAD_MUT.format(
        comment="  # repro: allow[FROZEN-MUT] test fixture resets "
                "a scratch table")}, rules=["FROZEN-MUT"])]


def suppress_standalone(side, root):
    return [side.lint(root, {"src/repro/core/bad.py": """\
        def poke(table):
            # repro: allow[FROZEN-MUT] scratch table, never cached
            table.cols[0] = 1.0
        """}, rules=["FROZEN-MUT"])]


def suppress_bare(side, root):
    return [side.lint(root, {"src/repro/core/bad.py": BAD_MUT.format(
        comment="  # repro: allow[FROZEN-MUT]")}, rules=["FROZEN-MUT"])]


def suppress_wrong_rule(side, root):
    return [side.lint(root, {"src/repro/core/bad.py": BAD_MUT.format(
        comment="  # repro: allow[SWEEP-LOOP] wrong id")},
        rules=["FROZEN-MUT"])]


def suppress_unused(side, root):
    return [side.lint(root, {"src/repro/core/ok.py": """\
        X = 1  # repro: allow[FROZEN-MUT] nothing here violates it
        """}, rules=["FROZEN-MUT"])]


def suppress_baseline(side, root):
    files = {"src/repro/core/bad.py": BAD_MUT.format(comment="")}
    first = side.lint(root, files, rules=["FROZEN-MUT"])
    base = root / "baseline.json"
    base.write_text(json.dumps(first.to_json()))
    return [first, side.lint(root, files, rules=["FROZEN-MUT"],
                             baseline=str(base))]


def parse_error(side, root):
    return [side.lint(root, {"src/repro/core/broken.py": "def f(:\n"},
                      rules=["FROZEN-MUT"])]


# case -> (unsuppressed errors, unsuppressed warnings, suppressed) of each
# report, as tests/test_contracts.py asserts them of the reference's linter
CASES = {
    sweep_fires: [(3, 0, 0)],
    sweep_quiet: [(0, 0, 0)],
    frozen_fires: [(5, 0, 0)],
    frozen_quiet: [(0, 0, 0)],
    loop_fires: [(3, 0, 0)],
    loop_quiet: [(0, 0, 0)],
    loop_other_modules: [(0, 0, 0)],
    fork_fires: [(2, 0, 0)],
    fork_quiet: [(0, 0, 0)],
    metric_fires: [(4, 1, 0)],
    metric_cross_check: [(1, 0, 0)],
    metric_new_family: [(1, 0, 0)],
    wire_quiet: [(0, 0, 0)],
    wire_renumber: [(1, 0, 0)],
    wire_removed: [(1, 0, 0)],
    wire_repacked: [(1, 0, 0)],
    wire_additive_then_refreshed: [(1, 0, 0), (0, 0, 0)],
    wire_missing_lock: [(1, 0, 0)],
    suppress_justified: [(0, 0, 1)],
    suppress_standalone: [(0, 0, 1)],
    suppress_bare: [(2, 0, 0)],
    suppress_wrong_rule: [(1, 1, 0)],
    suppress_unused: [(0, 1, 0)],
    suppress_baseline: [(1, 0, 0), (0, 0, 1)],
    parse_error: [(1, 0, 0)],
}


def findings(side, report):
    return [(f.rule, side.unrel(f.path), f.line, f.severity, f.suppressed)
            for f in report.findings]


def counts(side, report):
    return (len(report.errors),
            len(report.unsuppressed(side.analysis.WARNING)),
            sum(1 for f in report.findings if f.suppressed))


@pytest.mark.parametrize("case", list(CASES), ids=lambda c: c.__name__)
def test_fixture_case_matches_the_reference(case, tmp_path):
    ref = case(REF, tmp_path / "ref")
    port = case(PORT, tmp_path / "port")
    assert [counts(REF, r) for r in ref] == CASES[case]
    assert [findings(PORT, r) for r in port] == \
        [findings(REF, r) for r in ref]
    # the port's messages and hints are the reference's but for its paths
    for r_ref, r_port in zip(ref, port):
        for a, b in zip(r_ref.findings, r_port.findings):
            assert (unport(b.message), unport(b.hint)) == (a.message, a.hint)


def unport(text):
    """The port's paths and gate in ``text`` named as the reference's."""
    for ref_name, port_name in (
            ("src/repro", "src/repro_torch"),
            ("tests/test_obs.py", "tests/test_torch_obs.py"),
            ("benchmarks.check_contracts", "repro_torch.analysis")):
        text = text.replace(port_name, ref_name)
    return text


def test_every_reference_fixture_test_has_a_case():
    """The cases above are tests/test_contracts.py's fixture tests, one for
    one (its last two tests run the reference's own gate)."""
    import ast
    tree = ast.parse((ROOT / "tests" / "test_contracts.py").read_text())
    ref_tests = [n.name for n in sorted(
        (n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
         and n.name.startswith("test_")), key=lambda n: n.lineno)]
    assert ref_tests[-2:] == ["test_repo_lints_clean",
                              "test_check_contracts_gate_passes"]
    assert len(ref_tests) - 2 == len(CASES)


# ---------------------------------------------------------------------------
# The port lints clean, and the gate says so
# ---------------------------------------------------------------------------

# The port's justified allows (the findings they suppress): the CDNA3
# scalar-fallback rows, copied from the reference, and the device
# microbenchmark harness's two characterization loops.
PORT_ALLOWS = {("src/repro_torch/core/cdna3.py", "SWEEP-LOOP"): 1,
               ("src/repro_torch/core/microbench.py", "SWEEP-LOOP"): 2}


def test_port_lints_clean():
    report = port_analysis.run_checks()
    assert report.ok, "\n" + report.render(verbose=False)
    assert not report.unsuppressed(), report.render(verbose=False)
    allowed = {}
    for f in report.findings:
        assert f.suppressed and f.justification, f.render()
        key = (f.path, f.rule)
        allowed[key] = allowed.get(key, 0) + 1
    assert allowed == PORT_ALLOWS


def test_gate_passes_on_the_port():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep + \
        env.get("PYTHONPATH", "")
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--json"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert json.loads(out.stdout)["counts"] == {
        "errors": 0, "warnings": 0, "suppressed": 3}
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "-q"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.strip() == \
        "check_contracts: PASS — 0 error(s), 0 warning(s), 3 suppressed"


# A copy of the port with one violation of each rule: (rule, file, the text
# it follows, the text put after it).
MUTATIONS = {
    "SWEEP-LOOP": ("core/sweep.py", None,
                   "\n\ndef per_config(cfgs, hw):\n"
                   "    return [predict(Workload(c), hw) for c in cfgs]\n"),
    "FROZEN-MUT": ("core/workload.py", None,
                   "\n\ndef poke(table):\n"
                   "    table.cols[0, 0] = 0.0\n"),
    "LOOP-BLOCK": ("serve/binserver.py", "    def _loop(self) -> None:\n",
                   "        time.sleep(0)\n"),
    "FORK-LOCK": ("core/roofline.py", None,
                  "\nimport threading\n\n_EXTRA_LOCK = threading.Lock()\n"),
    "METRIC-NAME": ("serve/server.py", None,
                    '\n_COMPUTED = metrics.counter("repro_serve_" + "x_total",'
                    ' "a computed family")\n'),
    "WIRE-DRIFT": ("serve/codec.py", "MSG_TABLE = 1", "2"),
}


@pytest.fixture(scope="module")
def port_copy(tmp_path_factory):
    """The port's linted tree and its metric contract test, copied."""
    root = tmp_path_factory.mktemp("port_copy")
    shutil.copytree(ROOT / "src" / "repro_torch", root / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "csrc"))
    (root / "tests").mkdir()
    shutil.copy(ROOT / "tests" / "test_torch_obs.py", root / "tests")
    return root


def run_gate(root, capsys):
    capsys.readouterr()
    rc = gate.main(["--root", str(root), "--json"])
    return rc, json.loads(capsys.readouterr().out)


def test_gate_passes_on_the_copy(port_copy, capsys):
    rc, report = run_gate(port_copy, capsys)
    assert rc == 0 and report["counts"]["errors"] == 0


@pytest.mark.parametrize("rule", sorted(MUTATIONS))
def test_gate_fails_a_copy_that_breaks_the_rule(rule, port_copy, capsys):
    rel, after, text = MUTATIONS[rule]
    path = port_copy / "src" / "repro_torch" / rel
    saved = path.read_text()
    if after is None:
        mutated = saved + text
    else:
        assert saved.count(after) == 1
        mutated = saved.replace(after, after + text)
    path.write_text(mutated)
    try:
        rc, report = run_gate(port_copy, capsys)
    finally:
        path.write_text(saved)
    errors = [f for f in report["findings"]
              if not f["suppressed"] and f["severity"] == "error"]
    assert rc == 1
    assert errors and {f["rule"] for f in errors} == {rule}, errors


# ---------------------------------------------------------------------------
# The lock, and what the linter imports
# ---------------------------------------------------------------------------

def test_port_lock_is_the_reference_lock():
    assert (ROOT / port_wire.LOCK_REL).read_bytes() == \
        (ROOT / ref_wire.LOCK_REL).read_bytes()


def test_path_constants_point_at_the_port():
    from repro_torch.analysis.rules import loop_block, metric_name, \
        sweep_loop
    assert port_analysis.DEFAULT_PATHS == ("src/repro_torch",)
    assert Path(port_analysis.repo_root()) == ROOT
    assert (port_wire.LOCK_REL, port_wire.CODEC_REL,
            port_wire.FRAMING_REL) == (
        "src/repro_torch/analysis/wire_schema.lock.json",
        "src/repro_torch/serve/codec.py", "src/repro_torch/serve/framing.py")
    assert loop_block.EVENT_LOOP_FILES == {
        "repro_torch/serve/binserver.py": ("_loop",)}
    assert metric_name.EXEMPT_PATHS == ("repro_torch/obs/metrics.py",)
    assert metric_name.CONTRACT_TEST_REL == "tests/test_torch_obs.py"
    assert sweep_loop.ALLOWED_PATHS == ("repro_torch/core/suites/",)
    assert sorted(port_analysis.RULES) == sorted(ref_analysis.RULES)


def test_importing_the_linter_loads_no_torch():
    code = ("import sys\n"
            "import repro_torch.analysis, repro_torch.analysis.rules\n"
            "import repro_torch.analysis.__main__\n"
            "bad = sorted(m for m in sys.modules\n"
            "             if m.split('.')[0] in ('torch', 'jax', 'repro',\n"
            "                                    'numpy'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=60)
    assert out.returncode == 0, out.stdout + out.stderr
