#!/usr/bin/env python3
"""The designs weighed for flash attention at head dim 256 and for the
matmul's tiles, each against the kept source, on one NVIDIA Hopper card.

Each variant is the kept kernel source with a few edits:

flash attention (``src/repro_torch/csrc/flash_attention.cu``, bf16
``attn_fwd_tc<256>``):

- "kept": 16-key K/V tiles, the tile copy loop rolled at D = 256;
- "unrolled": the copy loop fully unrolled at D = 256 too;
- "keys32": 32-key tiles, the copy loop rolled;
- "keys32_unrolled": 32-key tiles, the copy loop unrolled.

matmul (``src/repro_torch/csrc/matmul.cu``):

- "kept";
- "warps_2x4": the 64x128 tile with eight 32x32 warps, not four 64x32;
- "stage_unroll4": the cp.async staging loop unrolled 4 times, not fully;
- "kstep_unroll4": the 8-deep k-step loop of a 64-deep slice unrolled 4
  times, not fully.

For each variant the script prints ptxas's registers and spills of every
kernel instantiation the edits touch, then:

- flash: the bf16 gate of ``chip_smoke.py`` (atol 1e-3 + rtol 1e-2 against
  the plain version) at recurrentgemma-9b's shape (``chip_smoke.D256``) and
  at the two D = 256 cases of ``chip_smoke.CHECKS``, as a gate ratio
  max(|err| / (atol + rtol |want|)) (above 1 fails); the kernel's time at
  that shape and at danube's main-path shape (D = 80, which no edit
  touches) with CUDA events, mean of 10 calls, in the order
  kept, unrolled, keys32, keys32_unrolled and back;
- matmul: whether every tile gives the same bits, and the same bits as the
  kept source, on a ragged 1000 x 520 x 640 product in fp32 and bf16; every
  fp32 tile's time at 8192^3 (mean of 5) and the bf16 128x128 tile's
  (mean of 10), in the order kept, warps_2x4, stage_unroll4, kstep_unroll4
  and back.

    python3 scripts/kernel_variants.py

Prints the card's name and power limit, one line per measurement, and a
JSON object last.  Needs a card and nvcc; builds into ``build/variants/``.
"""
from __future__ import annotations

import ctypes
import json
import re
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
from repro_torch.kernels.matmul import kernel as mm_kernel  # noqa: E402

# Each variant's edits of the kept source: every text must occur exactly
# once, so a change of the kernel that they no longer fit stops the script.
UNROLL_COPY = ("#pragma unroll (D > 128 ? 1 : 8)\n", "#pragma unroll\n")
KEYS32 = ("  return D > 128 ? 16 : 64;", "  return D > 128 ? 32 : 64;")
FLASH_EDITS = {"kept": [], "unrolled": [UNROLL_COPY], "keys32": [KEYS32],
               "keys32_unrolled": [KEYS32, UNROLL_COPY]}
MATMUL_EDITS = {
    "kept": [],
    "warps_2x4": [("    return launch_types<64, 128, 1, 4>(",
                   "    return launch_types<64, 128, 2, 4>(")],
    "stage_unroll4": [("    constexpr int CPR = COLS / CHUNK;\n"
                       "#pragma unroll\n",
                       "    constexpr int CPR = COLS / CHUNK;\n"
                       "#pragma unroll 4\n")],
    "kstep_unroll4": [("#pragma unroll\n"
                       "        for (int kk = 0; kk < BK; kk += 8) {",
                       "#pragma unroll 4\n"
                       "        for (int kk = 0; kk < BK; kk += 8) {")],
}
# ptxas lines kept: the bf16 flash kernel at D = 256; every matmul kernel.
PTXAS_KEEP = {"flash_attention": r"attn_fwd_tcILi256E",
              "matmul": r"matmul_kernel"}


def variant_source(src: str, edits) -> str:
    for old, new in edits:
        if src.count(old) != 1:
            raise ValueError(f"the kernel source holds {src.count(old)} "
                             f"copies of {old!r}, not one")
        src = src.replace(old, new)
    return src


def build_variant(kernel: str, name: str, src: str) -> tuple:
    out = ROOT / "build" / "variants" / f"{kernel}_{name}"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"{kernel}.cu").write_text(src)
    lib = out / f"lib{kernel}.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o",
                           str(lib), str(out / f"{kernel}.cu")],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {kernel} {name}:\n{proc.stderr}")
    return lib, proc.stdout + proc.stderr


def ptxas_usage(log: str, keep: str) -> dict:
    """{mangled kernel name: {"registers": n, "spill_stores": bytes,
    "spill_loads": bytes}} from ``-Xptxas -v`` output."""
    out, current = {}, None
    for line in log.splitlines():
        entry = re.search(r"entry function '(\w+)'", line)
        if entry:
            current = entry.group(1) if re.search(keep, line) else None
            if current:
                out[current] = {}
            continue
        if current is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill:
            out[current]["spill_stores"] = int(spill.group(1))
            out[current]["spill_loads"] = int(spill.group(2))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            out[current]["registers"] = int(regs.group(1))
    return out


def gate_ratio(got, want, tol) -> float:
    want = want.float()
    return ((got.float() - want).abs()
            / (tol["atol"] + tol["rtol"] * want.abs())).max().item()


def there_and_back(names):
    return list(names) + list(reversed(names))


def flash(libs: dict, result: dict) -> None:
    tol = smoke.KERNEL_TOL[torch.bfloat16]
    gen = generator(smoke.SEED, "cuda")
    cases = [c for c in smoke.CHECKS if c[5] == 256] + [smoke.D256]
    for spec in cases:
        name, b, hq, hkv, s, d, causal, window, strided = spec
        q, k, v = smoke.attention_inputs(b, hq, hkv, s, d, torch.bfloat16,
                                         strided, gen)
        kw = dict(sm_scale=d ** -0.5, causal=causal, window=window)
        want = fa_ref.attention(q, k, v, **kw)
        for variant, lib in libs.items():
            _build._loaded["flash_attention"] = lib
            ratio = gate_ratio(fa_kernel.mha(q, k, v, **kw), want, tol)
            result["gate_ratio"].setdefault(variant, {})[name] = ratio
            smoke.phase("variants", kernel="flash_attention", case=repr(name),
                        variant=variant, gate_ratio=f"{ratio:.4f}")
        del q, k, v, want
        torch.cuda.empty_cache()
    shapes = {}
    for key, spec in (("d256", smoke.D256), ("d80", smoke.MAIN)):
        _, b, hq, hkv, s, d, causal, window, strided = spec
        q, k, v = smoke.attention_inputs(b, hq, hkv, s, d, torch.bfloat16,
                                         strided, gen)
        shapes[key] = (q, k, v, dict(sm_scale=d ** -0.5, causal=causal,
                                     window=window))
    for variant in there_and_back(libs):
        _build._loaded["flash_attention"] = libs[variant]
        for key, (q, k, v, kw) in shapes.items():
            ms = smoke.cuda_ms(lambda: fa_kernel.mha(q, k, v, **kw), reps=10,
                               warmup=2)
            result["ms"].setdefault(variant, {}).setdefault(key, []).append(
                ms)
            smoke.phase("variants", kernel="flash_attention", shape=key,
                        variant=variant, kernel_ms=f"{ms:.4f}")
    del shapes
    torch.cuda.empty_cache()


def matmul(libs: dict, result: dict) -> None:
    gen = generator(smoke.SEED + 5, "cuda")
    small = (torch.randn((1000, 520), generator=gen, device="cuda"),
             torch.randn((520, 640), generator=gen, device="cuda"))
    kept = {}
    for variant, lib in libs.items():
        _build._loaded["matmul"] = lib
        same = True
        for dtype in (torch.float32, torch.bfloat16):
            a, b = (x.to(dtype) for x in small)
            outs = [mm_kernel.matmul_tiled(a, b, bm=bm, bn=bn)
                    for bm, bn in mm_kernel.TILES[dtype]]
            kept.setdefault(dtype, outs[0])
            same &= all(torch.equal(o, kept[dtype]) for o in outs)
        result["same_bits"][variant] = same
        smoke.phase("variants", kernel="matmul", variant=variant,
                    same_bits_as_kept_every_tile=same)
    big = (torch.randn((8192, 8192), generator=gen, device="cuda"),
           torch.randn((8192, 8192), generator=gen, device="cuda"))
    big16 = tuple(x.bfloat16() for x in big)
    for variant in there_and_back(libs):
        _build._loaded["matmul"] = libs[variant]
        row = {f"fp32 {bm}x{bn}": smoke.cuda_ms(
                   lambda bm=bm, bn=bn: mm_kernel.matmul_tiled(
                       *big, bm=bm, bn=bn), reps=5, warmup=1)
               for bm, bn in mm_kernel.TILES[torch.float32]}
        row["bf16 128x128"] = smoke.cuda_ms(
            lambda: mm_kernel.matmul_tiled(*big16, bm=128, bn=128), reps=10,
            warmup=2)
        for key, ms in row.items():
            result["ms"].setdefault(variant, {}).setdefault(key, []).append(
                ms)
        smoke.phase("variants", kernel="matmul", shape="8192^3",
                    variant=variant,
                    **{k.replace(" ", "_") + "_ms": f"{v:.3f}"
                       for k, v in row.items()})
    del big, big16
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: this script measures kernels on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    plan = {"flash_attention": FLASH_EDITS, "matmul": MATMUL_EDITS}
    with ThreadPoolExecutor(sum(len(v) for v in plan.values())) as pool:
        futures = {
            (kernel, name): pool.submit(
                build_variant, kernel, name,
                variant_source((_build.CSRC / f"{kernel}.cu").read_text(),
                               edits))
            for kernel, variants in plan.items()
            for name, edits in variants.items()}
    result = {}
    for kernel in plan:
        libs, usage = {}, {}
        for (k, name), fut in futures.items():
            if k != kernel:
                continue
            lib, log = fut.result()
            libs[name] = ctypes.CDLL(str(lib))
            usage[name] = ptxas_usage(log, PTXAS_KEEP[kernel])
            for fn, use in usage[name].items():
                smoke.phase("variants", kernel=kernel, variant=name,
                            function=fn, **use)
        result[kernel] = {"ptxas": usage, "gate_ratio": {}, "same_bits": {},
                          "ms": {}}
        (flash if kernel == "flash_attention" else matmul)(libs,
                                                           result[kernel])
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
