"""Nothing the benchmark runs imports jax, jaxlib, flax or the reference
package ``repro`` (top-level names compared whole: ``repro_torch`` begins
with ``repro``), and the reference imports nothing of the program."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
FILES = sorted(p for p in HERE.rglob("*.py"))


def top_level_imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", FILES, ids=lambda p: p.name)
def test_no_file_imports_jax_or_the_reference_package(path):
    assert not top_level_imports(path) & FORBIDDEN


YARDSTICK = [HERE / f"{name}.py" for name in
             ("reference", "counts", "traffic", "tracing", "toy_moe")]
YARDSTICK += sorted((HERE / "references").glob("*.py"))


@pytest.mark.parametrize("path", YARDSTICK, ids=lambda p: p.stem)
def test_the_yardstick_imports_nothing_of_the_program(path):
    assert "repro_torch" not in top_level_imports(path)


def test_whole_name_comparison():
    from portbench import harness
    sys.modules.setdefault("repro_torchlike_probe", object())
    try:
        assert "repro_torchlike_probe" not in harness.forbidden_modules()
    finally:
        sys.modules.pop("repro_torchlike_probe", None)


def test_reference_loads_no_program_module():
    code = ("import sys; import portbench.reference, portbench.counts, "
            "portbench.traffic, portbench.tracing; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('repro_torch', 'repro', 'jax', 'jaxlib', 'flax')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
