"""Toy cells run end to end on the CPU: a cell, a mix and a per-layer
metric are added as files and entries alone; the comparison with the
reference passes the program and fails the fp8 control and each planted
fault; BENCHMARK.json keeps to the benchmark's contract."""
import json
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from portbench import harness, toy

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SEED = 2**31 + 77


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """The toy runs spin for their windows: on one thread, so they take no
    cores from the tests beside them."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return toy.write_root(tmp_path_factory.mktemp("toybench"))


def run(root, cell, **kw):
    kw.setdefault("trace", False)
    return harness.run_cell(cell, seed=SEED, seconds=0.3, root=root,
                            device="cpu", **kw)


@pytest.mark.parametrize("cell", sorted(toy.CELLS))
def test_toy_cell_is_correct_and_reports_its_metrics(root, cell):
    r = run(root, cell)
    assert r["correct"] is True, r["checks"]
    want = {m["name"] for m in json.loads(
        (root / "BENCHMARK.json").read_text())["end_to_end"]
        if cell in m.get("workloads", [cell])}
    assert set(r["metrics"]) == want
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert list(r)[-2:] == ["checks", "_run"]
    assert r["attempted"] > 0 and r["failed"] == 0


@pytest.mark.parametrize("cell", ["toy-danube.toy-prefill",
                                  "toy-danube.toy-train"])
def test_traced_run_reads_the_added_metric(root, cell):
    r = run(root, cell, trace=True)
    assert r["correct"] is True
    assert set(r["metrics"]) == {"toy_units"}
    assert r["metrics"]["toy_units"]["value"] >= 1
    assert r["device"]["window_s"] > 0
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}


@pytest.mark.parametrize("cell", sorted(toy.CELLS))
def test_control_fails_the_limits(root, cell):
    r = run(root, cell, control=True)
    control = r["_run"]["control"]
    assert r["correct"] is True
    limits = json.loads((root / "portbench" / "limits" / f"{cell}.json")
                        .read_text())
    assert not harness.passed(harness.compare(control, limits)), control


def test_altered_token_fails(root, monkeypatch):
    from repro_torch.train import serve_step
    whole = serve_step.make_prefill

    def altered(model):
        prefill = whole(model)

        def run_altered(tokens):
            logits = prefill(tokens).clone()
            top = logits.argmax(-1, keepdim=True)
            return logits.scatter(-1, top, float(logits.min()) - 1.0)
        return run_altered
    monkeypatch.setattr(serve_step, "make_prefill", altered)
    r = run(root, "toy-danube.toy-prefill")
    assert r["correct"] is False
    assert r["checks"]["token_gap"]["value"] > 1e-3


def test_unchanged_state_fails(root, monkeypatch):
    from repro_torch.train import train_step as ts

    def frozen(model, **kw):
        def step(state, batch):
            with torch.no_grad():
                loss, _ = model.loss_fn(batch)
            return state, {"loss": loss}
        return step
    monkeypatch.setattr(ts, "make_train_step", frozen)
    r = run(root, "toy-danube.toy-train")
    assert r["correct"] is False
    assert r["checks"]["change_gap"]["value"] > 0.5


def test_half_batch_fails(root, monkeypatch):
    from repro_torch.train import train_step as ts
    whole = ts.make_train_step

    def halved(*a, **kw):
        step = whole(*a, **kw)
        return lambda state, batch: step(
            state, {k: v[:v.shape[0] // 2] for k, v in batch.items()})
    monkeypatch.setattr(ts, "make_train_step", halved)
    r = run(root, "toy-danube.toy-train")
    assert r["correct"] is False


def test_missing_limits_fail(root, tmp_path):
    bare = toy.write_root(tmp_path)
    (bare / "portbench" / "limits" / "toy-mamba.toy-prefill.json").unlink()
    r = run(bare, "toy-mamba.toy-prefill")
    assert r["correct"] is False
    assert r["checks"]["logit_err"]["limit"] is None


def test_command_refuses_without_a_card(tmp_path):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    out = subprocess.run(
        [sys.executable, str(ROOT / "portbench" / "run.py"), "--workload",
         bench["workloads"][0]["name"], "--seed", str(2**31 + 9),
         "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    assert out.returncode != 0
    assert out.stdout.strip() == ""


# ------------------------------------------------------- BENCHMARK.json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def keeps_keys_and_names(bench, root):
    assert set(bench) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["portbench"]
    assert 1 <= bench["run_seconds"] <= 51
    metrics = bench["end_to_end"] + bench["per_layer"]
    names = [x["name"] for x in bench["configs"] + bench["workloads"]
             + metrics]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
               for m in metrics)
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (root / c["file"]).is_file()
        assert c["file"].startswith("portbench/")
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert len(w["why"]) <= 200 and w["chips"] == 1
        assert (root / "portbench" / "traffic" / f"{w['traffic']}.json"
                ).is_file()
        assert (root / "portbench" / "limits" / f"{w['name']}.json"
                ).is_file()


def reports_setup_another_metric_and_a_layer(bench, root):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25 and "workloads" not in \
        e2e["setup_s"]
    assert all(0.01 <= m["bound"] <= 0.25 and m["source"] in
               ("host_clock", "device_trace") for m in e2e.values())
    cells = [w["name"] for w in bench["workloads"]]
    for m in bench["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and harness.reader_path(
            root / "portbench" / "metrics", m["name"]).is_file()
        for w in m["workloads"]:
            assert w in e2e[m["moves"]].get("workloads", cells)
    for cell in cells:
        reported = [n for n, m in e2e.items()
                    if cell in m.get("workloads", cells)]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m["workloads"] for m in bench["per_layer"])


def test_benchmark_keys_and_names():
    keeps_keys_and_names(BENCH, ROOT)


def test_every_cell_reports_setup_another_metric_and_a_layer():
    reports_setup_another_metric_and_a_layer(BENCH, ROOT)


def test_a_cell_whose_configuration_brings_a_module_keeps_to_them(
        tmp_path):
    """The same two checks over the real benchmark with a cell added whose
    configuration brings its own module, as a later PR adds one."""
    root = toy.write_real_with_module(tmp_path)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    assert toy.MODULE_CELL in {w["name"] for w in bench["workloads"]}
    keeps_keys_and_names(bench, root)
    reports_setup_another_metric_and_a_layer(bench, root)
