"""The per-layer metrics that read the program's compute spans: each
reads a number in a traced toy cell it applies to, and None where the
roots do not match the traced requests or steps, or where the program
records no compute spans."""
import json
import shutil
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

from portbench import harness, toy

HERE = Path(__file__).resolve().parent
SEED = 2**31 + 7919
PREFILL = ["toy-danube.toy-prefill", "toy-mamba.toy-prefill"]
# each span metric and the toy cells it applies to, as BENCHMARK.json
# lists the real ones
SPAN_METRICS = {
    "host_us_per_tok.prefill": PREFILL,
    "attention_us_per_tok": ["toy-danube.toy-prefill"],
    "mlp_us_per_tok": ["toy-danube.toy-prefill"],
    "ssm_us_per_tok": ["toy-mamba.toy-prefill"],
    "norm_us_per_tok": PREFILL,
    "optimizer_ms.train": ["toy-danube.toy-train"],
}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def empty_ring():
    from repro_torch.obs import compute
    compute.clear()
    yield
    compute.clear()


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """The toy benchmark with the span metrics' files and entries added."""
    root = toy.write_root(tmp_path_factory.mktemp("spanbench"))
    real = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in real["per_layer"]}
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for name, cells in SPAN_METRICS.items():
        shutil.copy(HERE / "metrics" / f"{name}.py",
                    root / "portbench" / "metrics" / f"{name}.py")
        bench["per_layer"].append(dict(entries[name], workloads=cells))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def traced_run(root, cell):
    return harness.run_cell(cell, seed=SEED, seconds=0.3, root=root,
                            device="cpu", trace=True)


@pytest.mark.parametrize("cell", sorted(toy.CELLS))
def test_traced_toy_cell_reads_each_span_metric(root, cell):
    r = traced_run(root, cell)
    assert r["correct"] is True
    want = {m for m, cells in SPAN_METRICS.items() if cell in cells}
    got = {k: v["value"] for k, v in r["metrics"].items()
           if k in SPAN_METRICS}
    assert set(got) == want
    assert all(v > 0 for v in got.values()), got


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_reader_refuses_roots_that_do_not_match(root, name):
    cell = SPAN_METRICS[name][0]
    traced_run(root, cell)
    from repro_torch.obs import compute
    roots = [s for s in compute.compute_spans() if s.parent_id == 0]
    assert roots
    read = harness.reader(harness.load_cell(cell, root), name)

    def window(n):
        return SimpleNamespace(prompts=[{}] * n if "prefill" in cell else [],
                               steps=n if "train" in cell else 0)
    assert read(window(len(roots))) > 0
    assert read(window(len(roots) + 1)) is None
    assert read(window(len(roots) - 1)) is None


@pytest.mark.parametrize("name", sorted(SPAN_METRICS))
def test_reader_reads_none_from_a_program_without_compute_spans(
        root, name, monkeypatch):
    cell = SPAN_METRICS[name][0]
    traced_run(root, cell)
    from repro_torch.obs import compute
    n = len([s for s in compute.compute_spans() if s.parent_id == 0])
    # a program without the module: importing it raises ImportError
    from repro_torch import obs
    monkeypatch.delattr(obs, "compute")
    monkeypatch.setitem(sys.modules, "repro_torch.obs.compute", None)
    read = harness.reader(harness.load_cell(cell, root), name)
    assert read(SimpleNamespace(prompts=[{}] * n, steps=n)) is None
