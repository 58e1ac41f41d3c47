"""The port's examples (``examples_torch/``) on the CPU.

Each of the six runs to exit 0 in a subprocess (the training ones with
``--device cpu``), except the hardware library's measuring command,
``calibrate``, which runs in-process with the suite's timing stubbed so
that its upload goes through the port's server.  The sections that are the
reference example's host code print the same lines as the reference's
functions run in this process (timings masked).  Without a card and
without ``--device cpu`` the training examples raise.
"""
import ast
import contextlib
import importlib.util
import io
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
REF_DIR = ROOT / "examples"
PORT_DIR = ROOT / "examples_torch"
NAMES = ("autotune_plan", "hardware_library", "predict_performance",
         "quickstart", "serve_predictions", "train_lm")
LOSSES = re.compile(r"loss (\S+) -> (\S+)")


def run_example(name, *args, env=None, check=True, timeout=240):
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, str(PORT_DIR / f"{name}.py"),
                          *args], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=timeout)
    if check:
        assert out.returncode == 0, out.stdout + out.stderr
    return out


def load(directory, name):
    spec = importlib.util.spec_from_file_location(
        f"_{directory.name}_{name}", directory / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def printed(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


def untimed(text):
    """``text`` with host-clock readings (and tracemalloc's peak) masked."""
    for pattern, mask in ((r"\s*\d[\d,]*(\.\d+)? cfg/s", " <rate> cfg/s"),
                          (r"in\s+\d+(\.\d+)? ms", "in <t> ms"),
                          (r"\(\d+(\.\d+)? s\)", "(<t> s)"),
                          (r"peak memory \d+(\.\d+)? MB", "peak memory <m>")):
        text = re.sub(pattern, mask, text)
    return text


def test_every_reference_example_has_its_port():
    assert sorted(p.stem for p in REF_DIR.glob("*.py")) == list(NAMES)
    assert sorted(p.stem for p in PORT_DIR.glob("*.py")) == list(NAMES)


@pytest.mark.parametrize("name", NAMES)
def test_example_imports_the_port_torch_and_numpy_only(name):
    tree = ast.parse((PORT_DIR / f"{name}.py").read_text())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            roots.add(node.module.split(".")[0])
    assert "repro_torch" in roots
    assert roots - set(sys.stdlib_module_names) <= {
        "repro_torch", "torch", "numpy"}


def test_predict_performance_prints_the_reference_lines():
    port = run_example("predict_performance").stdout
    ref = printed(load(REF_DIR, "predict_performance").main)
    assert "same winner: True" in port
    assert untimed(port) == untimed(ref)


def test_quickstart_parts_1_2_and_training_on_the_cpu():
    port = run_example("quickstart", "--device", "cpu").stdout
    ref = printed(load(REF_DIR, "quickstart").perf_model_demo)
    assert port.startswith(ref)
    assert "3. Train a tiny minicpm-family model (WSD schedule) 30 steps" \
        in port[len(ref):]
    assert "[train] step 30/30" in port
    first, last = (float(x) for x in LOSSES.findall(port)[-1])
    assert last < first


def test_autotune_plan_prints_the_reference_part_1_and_prices_the_h100():
    from repro_torch.kernels.matmul.ops import select_blocks
    port = run_example("autotune_plan").stdout
    ref = printed(load(REF_DIR, "autotune_plan").tile_selection_mi300a)
    assert port.startswith(ref)
    part2, part3 = port[len(ref):].split("3. SPMD plan selection")
    assert "2. Hopper tile selection (the H100 matmul kernel)" in part2
    best, costs = select_blocks(8192, 8192, 8192)
    tiles = re.findall(r"blocks (\(\d+, \d+, \d+\))", part2)
    assert sorted(tiles) == sorted(str(b) for b in costs)
    assert f"blocks {str(best):18s}: {costs[best] * 1e3:8.3f} ms " \
        f"<- selected" in part2
    assert part3.startswith(": llama3-405b train_4k on 16x16 H100")
    assert "NVLink 4" in part3
    plans = re.findall(r"\[(fits |OOM  )\] step\s+(\S+)s", part3)
    assert len(plans) == 12 and part3.count("<- selected") == 1
    assert all(float(s) < 100.0 for _, s in plans)   # links priced


@pytest.mark.parametrize("argv", [["list"], ["show", "b200"],
                                  ["show", "h100"], ["diff", "b200", "h200"]],
                         ids=" ".join)
def test_hardware_library_browsing_prints_the_reference_lines(argv):
    port = run_example("hardware_library", *argv).stdout
    ref = printed(load(REF_DIR, "hardware_library").main, argv)
    assert port.replace("src/repro_torch/", "src/repro/") == ref


def test_hardware_library_calibrate_uploads_through_the_port_server(
        monkeypatch, capsys):
    from repro_torch.core import microbench
    # the suite's timing loop stubbed out: each case still compiles and
    # runs once, none is timed
    monkeypatch.setattr(microbench, "measure_median",
                        lambda fn, **kw: (1.0, 0.0))
    load(PORT_DIR, "hardware_library").main(["calibrate", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "measuring the device microbenchmark suite on cpu" in out
    assert re.search(r"server pid \d+ at 127\.0\.0\.1:\d+ -> ok", out)
    assert "server fitted mode=class against its own predictions for " \
        "'cpu_host'" in out
    assert re.search(r"priced 27 tile configs on 'cpu_host': calibrated "
                     r"totals = raw x \d", out)


def test_serve_predictions_runs_against_the_port_server():
    out = run_example("serve_predictions").stdout
    assert "bit-identical to in-process: True" in out
    assert re.search(r"/v1/metrics \(\d+ exposition lines\)", out)


def test_train_lm_cpu_small_trains_and_checkpoints(tmp_path):
    out = run_example("train_lm", "--device", "cpu", "--steps", "3",
                      "--ckpt-dir", str(tmp_path)).stdout
    assert "[train_lm] lm-cpu-small: 5.0M params, 3 steps" in out
    first, last = (float(x) for x in LOSSES.findall(out)[-1])
    assert last < first
    assert (tmp_path / "ckpt_000003").is_dir()


@pytest.mark.parametrize("name,args", [("quickstart", []),
                                       ("train_lm", ["--steps", "1"])])
def test_training_examples_raise_without_a_card(name, args, tmp_path):
    if name == "train_lm":
        args = args + ["--ckpt-dir", str(tmp_path)]
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = run_example(name, *args, env=env, check=False)
    assert out.returncode != 0
    assert "pass device='cpu' to run on the host" in out.stderr
    assert not list(tmp_path.iterdir())
