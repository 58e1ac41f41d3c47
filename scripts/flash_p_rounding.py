#!/usr/bin/env python3
"""What the bf16 flash-attention kernel's split P buys and costs, measured on
one NVIDIA Hopper card.

The bf16 kernel (``attn_fwd_tc`` in ``src/repro_torch/csrc/flash_attention.cu``)
rounds P to bf16 as p_hi + p_lo and multiplies V twice.  This script builds
that source as it is ("split") and a variant with P rounded once ("once":
p_lo is 0 and its two products are gone, so l sums the rounded P alone),
then for each:

- the bf16 gate of ``chip_smoke.py`` (atol 1e-3 + rtol 1e-2 against the
  plain version) at windows 1 and 16 (its edge cases) and 4096 (the main
  path's shape): the max abs error and the gate ratio
  max(|err| / (atol + rtol |want|)); a ratio above 1 fails the gate;
- the kernel's time at the main path's shape (CUDA events, mean of 10
  calls), in the order split, once, once, split.

    python3 scripts/flash_p_rounding.py

Prints the card's name and power limit, one line per measurement, and a
JSON object last.  Needs a card and nvcc; builds into ``build/variants/``.
"""
from __future__ import annotations

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
from repro_torch.kernels.flash_attention import (  # noqa: E402
    kernel as fa_kernel, ref as fa_ref)

# The variant's edits of the kernel source: each text must occur exactly
# once, so a change of the kernel that they no longer fit stops the script.
ONCE_EDITS = [
    ("const bf16 l0 = __float2bfloat16(p[0] - __bfloat162float(h0));",
     "const bf16 l0 = __float2bfloat16(0.f);"),
    ("const bf16 l1 = __float2bfloat16(p[1] - __bfloat162float(h1));",
     "const bf16 l1 = __float2bfloat16(0.f);"),
    ("mma_bf16(acc[2 * dp], pl, b[0], b[1]);", ""),
    ("mma_bf16(acc[2 * dp + 1], pl, b[2], b[3]);", ""),
]
CASES = [c for c in smoke.CHECKS if c[0] in ("window 1", "window 16")] \
    + [smoke.MAIN]


def once_source(src: str) -> str:
    """The kernel source with P rounded once to bf16."""
    for old, new in ONCE_EDITS:
        if src.count(old) != 1:
            raise ValueError(f"the kernel source holds {src.count(old)} "
                             f"copies of {old!r}, not one")
        src = src.replace(old, new)
    return src


def build_once() -> Path:
    out = ROOT / "build" / "variants" / "flash_attention_once"
    out.mkdir(parents=True, exist_ok=True)
    src = out / "flash_attention.cu"
    src.write_text(once_source(
        (_build.CSRC / "flash_attention.cu").read_text()))
    lib = out / "libflash_attention.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                           str(lib), str(src)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on the variant:\n{proc.stderr}")
    return lib


def gate_ratio(got, want, tol) -> float:
    want = want.float()
    return ((got.float() - want).abs()
            / (tol["atol"] + tol["rtol"] * want.abs())).max().item()


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this script measures a kernel on the card",
              file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    with ThreadPoolExecutor(2) as pool:
        split_lib = pool.submit(_build.build, "flash_attention")
        once_lib = pool.submit(build_once)
    libs = {"split": ctypes.CDLL(str(split_lib.result())),
            "once": ctypes.CDLL(str(once_lib.result()))}
    # The edits are the mma.sync kernel's: keep every case on it, where the
    # wrapper's rule would send danube's head dim to the wgmma kernel.
    fa_kernel.WGMMA_HEAD_DIMS = ()
    tol = smoke.KERNEL_TOL[torch.bfloat16]
    gen = generator(smoke.SEED, "cuda")
    result = {"tol": tol, "cases": {}, "main_ms": {v: [] for v in libs}}
    for name, b, hq, hkv, s, d, causal, window, strided in CASES:
        q, k, v = smoke.attention_inputs(b, hq, hkv, s, d, torch.bfloat16,
                                         strided, gen)
        kw = dict(sm_scale=d ** -0.5, causal=causal, window=window)
        want = fa_ref.attention(q, k, v, **kw)
        row = {}
        for variant, lib in libs.items():
            _build._loaded["flash_attention"] = lib
            got = fa_kernel.mha(q, k, v, **kw)
            row[variant] = {"max_abs_err": smoke.max_abs_err(name, got, want),
                            "gate_ratio": gate_ratio(got, want, tol)}
            smoke.phase("p_rounding", case=repr(name), variant=variant,
                        max_abs_err=f"{row[variant]['max_abs_err']:.3e}",
                        gate_ratio=f"{row[variant]['gate_ratio']:.4f}")
        result["cases"][name] = row
        del want
        if (name, b, hq, hkv, s, d, causal, window, strided) == smoke.MAIN:
            for variant in ("split", "once", "once", "split"):
                _build._loaded["flash_attention"] = libs[variant]
                ms = smoke.cuda_ms(lambda: fa_kernel.mha(q, k, v, **kw),
                                   reps=10, warmup=2)
                result["main_ms"][variant].append(ms)
                smoke.phase("p_rounding", case=repr(name), variant=variant,
                            kernel_ms=f"{ms:.4f}")
        del q, k, v
        torch.cuda.empty_cache()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
