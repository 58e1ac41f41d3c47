#!/usr/bin/env python3
"""What the SSD kernel's 3xTF32 buys and costs, and how the kernel compares
with an earlier source of it, measured on one NVIDIA Hopper card.

The SSD scan (``src/repro_torch/csrc/ssd.cu``) runs its four products as
3xTF32.  This script builds that source as it is ("3xtf32") and a variant
with plain TF32 ("tf32": the two products with a lo part are gone, so each
product is hi.hi), and, with ``--parent PATH``, an earlier ``ssd.cu`` with
the same C entry point ("parent").  For each:

- every ssd check of ``chip_smoke.py`` (its edge cases, decay stability and
  the main path's shape, on the same inputs): the max abs error and the
  gate ratio max(|err| / (atol + rtol |want|)) against ``ssd_chunked``
  (1e-4), the exact scan (5e-4 / 5e-3) and, at the main shape, chunks 64
  and 128 against 256 (2e-4 / 2e-3); a ratio above 1 fails the gate;
- the main shape's time (CUDA events, mean of 20 calls), in the order
  parent, 3xtf32, 3xtf32, parent, tf32, and the time of each of the three
  passes (torch.profiler, mean of 10 calls).

    python3 scripts/ssd_variants.py [--parent build/parent/ssd.cu]

Prints the card's name and power limit, one line per measurement, and a
JSON object last.  Needs a card and nvcc; builds into ``build/variants/``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
from repro_torch.device import generator  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.ssd import kernel as ssd_kernel  # noqa: E402
from repro_torch.kernels.ssd import ref as ssd_ref  # noqa: E402

# The plain-TF32 variant's edits of the kernel source: each text must occur
# exactly once, so a change of the kernel that they no longer fit stops the
# script.
TF32_EDITS = [("  mma_tf32(c, a_lo, b_hi);\n", ""),
              ("  mma_tf32(c, a_hi, b_lo);\n", "")]
TIME_ORDER = ("parent", "3xtf32", "3xtf32", "parent", "tf32")


def tf32_source(src: str) -> str:
    """The kernel source with each product in plain TF32 (hi.hi alone)."""
    for old, new in TF32_EDITS:
        if src.count(old) != 1:
            raise ValueError(f"the kernel source holds {src.count(old)} "
                             f"copies of {old!r}, not one")
        src = src.replace(old, new)
    return src


def build_variant(name: str, src: str) -> Path:
    out = ROOT / "build" / "variants" / f"ssd_{name}"
    out.mkdir(parents=True, exist_ok=True)
    (out / "ssd.cu").write_text(src)
    lib = out / "libssd.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                           str(lib), str(out / "ssd.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}:\n{proc.stderr}")
    return lib


def gate_ratio(got, want, tol) -> float:
    want = want.float()
    return ((got.float() - want).abs()
            / (tol["atol"] + tol["rtol"] * want.abs())).max().item()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, default=None,
                    help="an earlier ssd.cu to measure beside this one")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device: this script measures a kernel on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    src = (_build.CSRC / "ssd.cu").read_text()
    sources = {"tf32": tf32_source(src)}
    if args.parent is not None:
        sources["parent"] = (ROOT / args.parent).read_text()
    with ThreadPoolExecutor(len(sources) + 1) as pool:
        futures = {"3xtf32": pool.submit(_build.build, "ssd")}
        futures.update({name: pool.submit(build_variant, name, text)
                        for name, text in sources.items()})
    libs = {name: ctypes.CDLL(str(fut.result()))
            for name, fut in futures.items()}

    def run(variant, xs, chunk):
        _build._loaded["ssd"] = libs[variant]
        y = ssd_kernel.ssd(*xs, chunk=chunk)
        torch.cuda.synchronize()
        return y

    result = {"cases": {}, "main_ms": {v: [] for v in libs},
              "passes_ms": {}}
    cases = smoke.ssd_cases(generator(smoke.SEED + 2, "cuda"))
    for name, xs, chunk in cases:
        wants = {"chunked": (ssd_ref.ssd_chunked(*xs, chunk=chunk),
                             smoke.SSD_TOL),
                 "exact": (ssd_ref.ssd_scan_ref(*xs), smoke.SSD_EXACT_TOL)}
        row = {}
        for variant in libs:
            y = run(variant, xs, chunk)
            row[variant] = {}
            for against, (want, tol) in wants.items():
                row[variant][against] = {
                    "max_abs_err": smoke.max_abs_err(name, y, want),
                    "gate_ratio": gate_ratio(y, want, tol)}
            if name == smoke.SSD_MAIN[0]:
                for other in (64, 128):
                    y_other = run(variant, xs, other)
                    row[variant][f"chunk {other} vs {chunk}"] = {
                        "max_abs_err": smoke.max_abs_err(name, y_other, y),
                        "gate_ratio": gate_ratio(y_other, y,
                                                 smoke.SSD_CHUNK_TOL)}
            smoke.phase("ssd_variants", case=repr(name), variant=variant,
                        **{f"{k}_{m}": f"{v[m]:.4g}"
                           for k, v in row[variant].items()
                           for m in ("max_abs_err", "gate_ratio")})
        result["cases"][name] = row
        del wants

    name, xs, chunk = cases[-1]
    for variant in TIME_ORDER:
        if variant not in libs:
            continue
        _build._loaded["ssd"] = libs[variant]
        ms = smoke.cuda_ms(lambda: ssd_kernel.ssd(*xs, chunk=chunk), reps=20,
                           warmup=2)
        result["main_ms"][variant].append(ms)
        smoke.phase("ssd_variants", case=repr(name), variant=variant,
                    kernel_ms=f"{ms:.4f}")
    for variant in libs:
        _build._loaded["ssd"] = libs[variant]
        passes = smoke.ssd_pass_ms(xs, chunk)
        result["passes_ms"][variant] = passes
        smoke.phase("ssd_variants", case=repr(name), variant=variant,
                    **{f"{k}_ms": f"{v:.4f}" for k, v in passes.items()})
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
