#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA
Hopper card: the quickest proof that the port still builds, agrees with its
plain versions, serves h2o-danube-1.8b and mamba2-1.3b at full width, and
runs the paper's loop (microbenchmark -> calibrate -> predict -> validate)
on the card.

    python3 chip_smoke.py

Phases, one line each (each raises on failure; the script then exits
non-zero and prints no result):

1. machine   - the card's name and power limit (nvidia-smi), torch, CUDA,
               nvcc, SM count, whether triton imports.
2. build     - nvcc builds every kernel of the paths from ``src/repro_torch/
               csrc``, one process per source, all started together; time
               and the compiler's report for each kernel function
               (registers, static shared memory, spills).
3. kernels   - each kernel against its plain PyTorch version on the card,
               at the main paths' shapes and at edge shapes; kernel, plain,
               library and bound times at the main paths' shapes, each
               line naming the kernel's design (DESIGN).
               flash_attention: fp32 at 5e-5 (the reference's kernel
               tolerance, tests/test_kernels.py:22), bf16 at atol 1e-3 +
               rtol 1e-2; head dims 64/80/128/256, and recurrentgemma-9b's
               shape (D=256, MQA, window 2048) timed in both dtypes.
               ssd (fp32 only, as the model sends it): 1e-4 against the
               plain chunked version, the reference's 5e-4 /
               5e-3 (tests/test_kernels.py:181) against the exact scan,
               chunks 64/128/256 agreeing at 2e-4 / 2e-3, and the
               decay-stability case finite; timed at mamba2's main shape
               beside its 3xTF32 and fp32 CUDA-core bounds, with each of
               its three passes timed by torch.profiler (the
               "[kernel] ssd passes" line).  matmul (fp32 and bf16):
               the reference's 5e-5 * sqrt(k) / 5e-2 * sqrt(k)
               (tests/test_kernels.py:112-114) at edge shapes and the
               suite's 4096^3 and 8192^3, every instantiated tile (four
               fp32, six bf16) giving the same bits, fp32 also against the fp64 product at the
               same tolerance (cuBLAS's distance from it printed beside
               the kernel's); 8192^3 timed in fp32 (beside the fp32
               CUDA-core and the 3xTF32 bounds) and in bf16.  rmsnorm
               (fp32 and bf16): the reference's 5e-5 / 5e-2 over rows
               1/100/65536 x D 8/64/1024/2560/8192/16384 and a
               leading-dims case.
   loop      - the paper's loop at the card's sizes, through
               ``launch.validate.validate_device``: calibrate_device
               (measured parameters beside the datasheet h100.json values;
               run three times, each parameter's median and range
               printed; the vector rate above half the fp32 peak and
               below the peak), the validation suite (12 cases, among
               them the hand-written matmul and rmsnorm), each case's
               measured, model and roofline times, and four MAEs against
               roofline MAE.  Launch counts read around it: matmul and
               rmsnorm as the suite implies, flash attention and ssd 0.
   tiles     - the paper's adaptive tile selection (§IV-B): at six GEMM
               shapes, every instantiated matmul tile's model time
               (``kernels/matmul/ops.select_blocks``) beside its measured
               time, the model's pick, the measured best, the regret and
               the rank correlation; every tile checked against the plain
               version and bit for bit; matmul launches counted.
4. prefill   - each model's main path: ``make_prefill`` at full width and
               depth (random weights from a seed) for one request of 8192
               tokens, with every kernel's launch count read around it;
               held against the plain path in fp32, timed in bf16 (and
               held there too for danube; see BF16_GATED).
               h2o-danube-1.8b reaches flash attention 24 times, mamba2-1.3b
               the SSD scan 48 times.
5. generate  - ``launch.serve.serve`` (batch 4, prompt 256, 32 new tokens)
               for each model; tokens checked, no kernel launched, the
               prompt's last-token logits of the kernel path held against
               the sequential cache prefill (danube in bf16, mamba2 in
               fp32).
6. result    - one JSON line listing every kernel, then the last line
               ``{"ok": true, "device": {...}}``.

TF32 is switched off for matmuls and cuDNN, so every fp32 product on the
card is a full fp32 product.  Nothing here imports JAX or the JAX package.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))
# torch.compile (the loop's compiled cases) compiles in this process rather
# than in a pool of worker processes, so the script leaves none behind.
os.environ.setdefault("TORCHINDUCTOR_COMPILE_THREADS", "1")

import torch  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import hardware, microbench  # noqa: E402
from repro_torch.device import generator  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attention import (  # noqa: E402
    kernel as fa_kernel, ref as fa_ref)
from repro_torch.kernels.matmul import (  # noqa: E402
    kernel as mm_kernel, matmul, ops as mm_ops, ref as mm_ref)
from repro_torch.kernels.rmsnorm import (  # noqa: E402
    kernel as rms_kernel, ref as rms_ref, rmsnorm)
from repro_torch.kernels.ssd import (  # noqa: E402
    kernel as ssd_kernel, ref as ssd_ref)
from repro_torch.launch.serve import serve, setup  # noqa: E402
from repro_torch.launch.validate import validate_device  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.train.serve_step import (  # noqa: E402
    greedy_generate, make_prefill)

DANUBE = "h2o-danube-1.8b"
MAMBA2 = "mamba2-1.3b"
SEED = 0
PREFILL_LEN = 8192          # danube: > window + 1 = 4097, the SWA mask bites
GEN_BATCH, GEN_PROMPT, GEN_NEW = 4, 256, 32
KERNELS = {"flash_attention": fa_kernel, "ssd": ssd_kernel,
           "matmul": mm_kernel, "rmsnorm": rms_kernel}

# Published H100 SXM peaks (dense): bf16 tensor cores, fp32 CUDA cores, HBM3.
# They hold for that card only: ``machine`` refuses any other.  "3xtf32" is
# the rate of an fp32 product made of three TF32 products on the tensor
# cores (495 TFLOP/s TF32), the way the matmul and SSD kernels compute
# fp32.
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12,
              "3xtf32": 495e12 / 3}
HBM_BYTES_PER_S = 3.35e12

# Kernel against its plain version.  fp32: the reference's kernel
# tolerance.  bf16: both sides compute scores and softmax in fp32; the
# kernel rounds P to bf16 as p_hi + p_lo (~16 bits, so ~2^-16 of |v|) before
# the product with V, and both round the output once, so they differ by at
# most one bf16 unit (under 2^-7 of the value, inside rtol) plus that small
# term; atol covers it and the fp32 sums' own difference.  At the main shape
# |out| is ~0.02 (4097 live keys), so the bound there is ~6% of a typical
# value.  P rounded once to bf16 would not hold it: rows with a few live keys
# would move by up to a bf16 unit of |v| (scripts/flash_p_rounding.py
# measures that variant on the card).
KERNEL_TOL = {torch.float32: {"atol": 5e-5, "rtol": 5e-5},
              torch.bfloat16: {"atol": 1e-3, "rtol": 1e-2}}
# Full-model logits, kernel path against the plain chunked path.  fp32: the
# two paths differ only in the order of fp32 sums (32-key tiles against
# whole-row einsums), compounded over 24 layers.  bf16: every op rounds its
# output to 8 mantissa bits, so where the paths' fp32 sums straddle a
# rounding boundary the bf16 values differ by one unit (0.4%), and those
# flips propagate through 24 layers; the bound is loose for that reason.
FP32_REQUEST_TOL = 1e-3
BF16_REQUEST_TOL = {"atol": 1e-1, "rtol": 5e-2}
# mamba2 runs its SSD kernel in fp32 whatever the model's dtype, so its fp32
# request (gated above) already holds the kernel.  In bf16 its 48 recurrent
# layers carry a rounding flip anywhere into every later token and layer,
# so two paths that differ only in the order of fp32 sums give bf16 logits
# as far apart as the bound itself: a bf16 bound could not tell a fault from
# rounding.  For mamba2 the bf16 difference is printed beside the fp32 gate,
# not gated, and the prompt logits of make_prefill are held against the
# sequential cache prefill in fp32 (the served weights cast up).
BF16_GATED = {DANUBE: True, MAMBA2: False}
PROMPT_CHECK_DTYPE = {DANUBE: torch.bfloat16, MAMBA2: torch.float32}
# SSD kernel against ``ssd_chunked`` at the same chunk: the same algorithm
# in fp32 with its sums in another order (64-deep 3xTF32 partials, a warp
# scan for the cumsum, the decay applied after the C.h product).
SSD_TOL = {"atol": 1e-4, "rtol": 1e-4}
SSD_EXACT_TOL = {"atol": 5e-4, "rtol": 5e-3}     # tests/test_kernels.py:181
SSD_CHUNK_TOL = {"atol": 2e-4, "rtol": 2e-3}     # tests/test_kernels.py:198
# matmul and rmsnorm against their plain versions: the reference's kernel
# tolerances (tests/test_kernels.py:22); for the matmul atol is tol * sqrt(k)
# (tests/test_kernels.py:112-114).
MM_RMS_TOL = {torch.float32: 5e-5, torch.bfloat16: 5e-2}
# What each kernel computes with, by input type: printed on its lines and
# kept in its entry of the kernels JSON line.
DESIGN = {"flash_attention": {torch.bfloat16: "mma.sync bf16 + cp.async",
                              torch.float32: "fp32 FMA, CUDA cores"},
          "matmul": {torch.float32: "3xTF32 mma.sync + cp.async",
                     torch.bfloat16: "mma.sync bf16"},
          "ssd": {torch.float32: "3xTF32 mma.sync + cp.async, scores once "
                                 "per 16 heads"}}


def phase(label: str, **fields) -> None:
    print(f"[{label}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def max_abs_err(what: str, got, want) -> float:
    """Max |got - want|; raises if ``got`` has a non-finite value."""
    if not torch.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite values")
    return (got.float() - want.float()).abs().max().item()


def check_close(what: str, got, want, *, atol: float, rtol: float) -> float:
    err = max_abs_err(what, got, want)
    if not torch.allclose(got.float(), want.float(), atol=atol, rtol=rtol):
        raise AssertionError(f"{what}: max abs err {err:.3e} outside "
                             f"atol={atol} rtol={rtol}")
    return err


def cuda_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean device time of ``fn`` over ``reps`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def host_ms(fn) -> float:
    """Wall time of one call that ends in a device synchronise."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


# --------------------------------------------------------------- phase 1-2

def machine() -> None:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    microbench.base_params()    # raises unless this is the SXM5 H100
    try:
        import triton  # noqa: F401
        has_triton = True
    except ImportError:
        has_triton = False
    props = torch.cuda.get_device_properties(0)
    phase("machine", card=repr(smi), torch=torch.__version__,
          cuda=torch.version.cuda, nvcc=_build.nvcc_path(),
          sm_count=props.multi_processor_count,
          memory_gb=round(props.total_memory / 1e9, 1), triton=has_triton)


def build_kernels() -> None:
    t0 = time.perf_counter()
    libs = _build.build_all(list(KERNELS))
    secs = time.perf_counter() - t0
    for name, lib in libs.items():
        phase("build", kernel=name, seconds=f"{secs:.1f}",
              library=lib.relative_to(ROOT))
        for line in (lib.parent / "build.log").read_text().splitlines():
            if any(w in line for w in ("entry function", "registers",
                                       "spill")):
                print(f"  ptxas: {line.strip()}", flush=True)


def reset_launches() -> None:
    for mod in KERNELS.values():
        mod.launches = 0


def read_launches() -> dict:
    return {name: mod.launches for name, mod in KERNELS.items()}


def expected_launches(cfg) -> dict:
    """Kernel launches of one ``make_prefill`` request with the kernels on:
    one flash-attention call per attention block, one SSD call per ssm
    block; the models never reach the matmul or rmsnorm kernels, as in the
    reference."""
    per_group = {"flash_attention": sum(k in ("attn", "local_attn")
                                        for k in cfg.pattern),
                 "ssd": sum(k == "ssm" for k in cfg.pattern),
                 "matmul": 0, "rmsnorm": 0}
    return {name: cfg.n_groups * n for name, n in per_group.items()}


def check_launches(what: str, got: dict, want: dict) -> None:
    if got != want:
        raise AssertionError(f"{what}: kernel launches {got}, want {want}")


# ----------------------------------------------------------------- phase 3

def live_pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs the masks leave, i.e. the work these inputs
    need."""
    q = torch.arange(s, dtype=torch.int64)
    hi = q if causal else torch.full_like(q, s - 1)
    lo = (q - window).clamp(min=0) if window > 0 else torch.zeros_like(q)
    return int((hi - lo + 1).clamp(min=0).sum())


def attention_flops(b, hq, s, d, causal, window) -> float:
    return 4.0 * d * live_pairs(s, causal, window) * b * hq


def attention_bound_ms(b, hq, hkv, s, d, causal, window, dtype):
    flops = attention_flops(b, hq, s, d, causal, window)
    nbytes = torch.finfo(dtype).bits // 8 * (2 * b * hq * s * d
                                              + 2 * b * hkv * s * d)
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def attention_inputs(b, hq, hkv, s, d, dtype, strided, gen):
    """q (B,Hq,S,D), k, v (B,Hkv,S,D).  ``strided``: transposed views of
    (B,S,H,D) tensors, the layout the model hands the kernel."""
    def make(h):
        if strided:
            return torch.randn((b, s, h, d), generator=gen,
                               device="cuda").to(dtype).transpose(1, 2)
        return torch.randn((b, h, s, d), generator=gen,
                           device="cuda").to(dtype)
    return make(hq), make(hkv), make(hkv)


CHECKS = [  # name, b, hq, hkv, s, d, causal, window, strided
    ("danube S=2048 w=4096", 1, 32, 8, 2048, 80, True, 4096, True),
    ("danube S=2048 w=256", 1, 32, 8, 2048, 80, True, 256, True),
    ("ragged S=1000", 1, 32, 8, 1000, 80, True, 4096, True),
    ("D=64 group 1", 1, 8, 8, 1024, 64, True, 0, False),
    ("D=64 group 4", 1, 32, 8, 1024, 64, True, 0, False),
    ("D=128 group 1", 1, 8, 8, 1024, 128, True, 0, False),
    ("D=128 group 4", 1, 32, 8, 1024, 128, True, 0, False),
    ("non-causal B=2", 2, 8, 2, 512, 80, False, 0, False),
    ("window 1", 1, 32, 8, 512, 80, True, 1, True),      # two live keys a row
    ("window 16", 1, 32, 8, 512, 80, True, 16, True),
    ("S=72 D=128", 1, 8, 2, 72, 128, True, 0, False),   # under one query tile
    ("D=256 ragged S=1000", 1, 16, 1, 1000, 256, True, 2048, False),
    ("D=256 strided S=2048 w=256", 1, 16, 1, 2048, 256, True, 256, True),
]
# The main path's call: one layer of the 8192-token prefill request, bf16.
MAIN = ("main path S=8192 w=4096", 1, 32, 8, PREFILL_LEN, 80, True, 4096,
        True)
# recurrentgemma-9b's local attention at the same prompt length: MQA, head
# dim 256, window 2048 (configs/recurrentgemma_9b.py).  No ported path runs
# that model yet; its shape is checked and timed in fp32 and bf16.
D256 = ("recurrentgemma-9b S=8192 w=2048 D=256", 1, 16, 1, PREFILL_LEN, 256,
        True, 2048, True)


def sdpa_ms(q, k, v, *, sm_scale, window, reps) -> float:
    """Yardstick only (the port never calls it): PyTorch's fused attention
    with the same boolean causal/window mask, on the kv heads repeated
    beforehand."""
    hq, hkv, s = q.shape[1], k.shape[1], q.shape[2]
    ids = torch.arange(s, device="cuda")
    mask = (ids[None, :] <= ids[:, None]) & (ids[None, :] >= ids[:, None]
                                             - window)
    k_rep = k.repeat_interleave(hq // hkv, dim=1)
    v_rep = v.repeat_interleave(hq // hkv, dim=1)
    return cuda_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k_rep, v_rep, attn_mask=mask, scale=sm_scale), reps=reps)


def case_shape(spec) -> dict:
    _, b, hq, hkv, s, d, causal, window, strided = spec
    return {"b": b, "hq": hq, "hkv": hkv, "s": s, "d": d, "causal": causal,
            "window": window,
            "layout": "strided (B,S,H,D)" if strided else "(B,H,S,D)"}


def timed_case(spec, dtype, gen) -> dict:
    """One attention case in ``dtype``: checked against the plain version,
    timed beside its bound, the plain version's and SDPA's time; prints its
    ``[kernel]`` line."""
    name, b, hq, hkv, s, d, causal, window, strided = spec
    q, k, v = attention_inputs(b, hq, hkv, s, d, dtype, strided, gen)
    kw = dict(sm_scale=d ** -0.5, causal=causal, window=window)
    got = fa_kernel.mha(q, k, v, **kw)
    torch.cuda.synchronize()
    tol = KERNEL_TOL[dtype]
    err = check_close(f"flash_attention {name} {dtype}", got,
                      fa_ref.attention(q, k, v, **kw), **tol)
    del got
    kernel_ms = cuda_ms(lambda: fa_kernel.mha(q, k, v, **kw), reps=10,
                        warmup=2)
    plain_ms = cuda_ms(lambda: fa_ref.attention(q, k, v, **kw), reps=3)
    library_ms = sdpa_ms(q, k, v, sm_scale=kw["sm_scale"], window=window,
                         reps=5)
    bound_ms, bound_by = attention_bound_ms(b, hq, hkv, s, d, causal, window,
                                            dtype)
    extra = {}
    if dtype == torch.bfloat16 and bound_by == "operations":
        # The work the design issues: P V twice (p_hi, p_lo), 6 D a live
        # pair.
        extra["split_p_bound_ms"] = f"{bound_ms * 1.5:.4f}"
    flops = attention_flops(b, hq, s, d, causal, window)
    dt = str(dtype)[6:]
    phase("kernel", kernel="flash_attention", case=repr(name), dtype=dt,
          design=repr(DESIGN["flash_attention"][dtype]),
          max_abs_err=f"{err:.3e}", tol=tol, kernel_ms=f"{kernel_ms:.4f}",
          plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
          bound_ms=f"{bound_ms:.4f}", bound_by=bound_by, **extra,
          tflops=f"{flops / kernel_ms / 1e9:.1f}")
    del q, k, v
    torch.cuda.empty_cache()
    return {"case": name, "dtype": dt, "max_abs_err": err, "tol": tol,
            "ms": kernel_ms, "plain_ms": plain_ms, "library_ms": library_ms,
            "bound_ms": bound_ms, "bound_by": bound_by}


def flash_attention_checks() -> dict:
    gen = generator(SEED, "cuda")
    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        # bf16 at the main shape is checked below, where it is timed.  fp32
        # there needs the plain version's 8.6 GB score matrix.
        cases = CHECKS + [MAIN] if dtype == torch.float32 else CHECKS
        for name, b, hq, hkv, s, d, causal, window, strided in cases:
            q, k, v = attention_inputs(b, hq, hkv, s, d, dtype, strided, gen)
            out = fa_kernel.mha(q, k, v, sm_scale=d ** -0.5, causal=causal,
                                window=window)
            torch.cuda.synchronize()
            want = fa_ref.attention(q, k, v, sm_scale=d ** -0.5,
                                    causal=causal, window=window)
            tol = KERNEL_TOL[dtype]
            err = check_close(f"flash_attention {name} {dtype}", out, want,
                              **tol)
            checks.append({"case": name, "dtype": str(dtype)[6:],
                           "max_abs_err": err, "tol": tol})
            phase("kernel", kernel="flash_attention", case=repr(name),
                  dtype=str(dtype)[6:],
                  design=repr(DESIGN["flash_attention"][dtype]),
                  max_abs_err=f"{err:.3e}", tol=tol)
            del q, k, v, out, want
            torch.cuda.empty_cache()

    main = timed_case(MAIN, torch.bfloat16, gen)
    checks.append({k: main[k] for k in ("case", "dtype", "max_abs_err",
                                        "tol")})
    d256 = {"shape": case_shape(D256)}
    for dtype in (torch.float32, torch.bfloat16):
        case = timed_case(D256, dtype, gen)
        d256[case["dtype"]] = {k: case[k] for k in (
            "max_abs_err", "tol", "ms", "plain_ms", "library_ms", "bound_ms",
            "bound_by")}
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention/kernel.py:100",
            "launches": None, "max_abs_err": main["max_abs_err"],
            "ms": main["ms"], "plain_ms": main["plain_ms"],
            "bound_ms": main["bound_ms"], "bound_by": main["bound_by"],
            "library_ms": main["library_ms"],
            "design": DESIGN["flash_attention"][torch.bfloat16],
            "shape": {**case_shape(MAIN), "dtype": "bfloat16"},
            "d256": d256, "checks": checks}


def ssd_work(b, s, h, p, n, chunk):
    """The operations and bytes of one SSD scan: the work the function needs
    on the live (j <= i) entries of each chunk, with C B^T once per chunk
    (it does not depend on the head); x, y, dt, a_log, b, c each moved
    once."""
    live = chunk * (chunk + 1) // 2
    per_chunk = 2 * live * n + h * (2 * live * p + 4 * chunk * n * p)
    flops = b * (s // chunk) * per_chunk
    nbytes = 4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * n)
    return flops, nbytes


def ssd_inputs(b, s, h, p, n, gen, *, model_a_log=False):
    """x ~ N(0,1), dt = softplus(N(0,1)), B and C ~ N(0,1)/sqrt(N), as the
    reference's tests draw them; a_log is 0.5 N(0,1) there, or the model's
    own init log(linspace(1, 16, H)) (decay rates up to 16)."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")
    x = randn(b, s, h, p)
    dt = torch.nn.functional.softplus(randn(b, s, h))
    if model_a_log:
        a_log = torch.log(torch.linspace(1.0, 16.0, h, device="cuda"))
    else:
        a_log = 0.5 * randn(h)
    return x, dt, a_log, randn(b, s, n) / n ** 0.5, randn(b, s, n) / n ** 0.5


SSD_PASSES = ("chunk_state", "state_passing", "chunk_scan")


def ssd_pass_ms(args, chunk: int, reps: int = 10) -> dict:
    """Device time of each of the SSD kernel's three passes, mean ms a call,
    from torch.profiler's CUDA trace over ``reps`` calls; raises unless the
    trace holds every pass ``reps`` times."""
    from torch.profiler import ProfilerActivity, profile
    ssd_kernel.ssd(*args, chunk=chunk)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            ssd_kernel.ssd(*args, chunk=chunk)
        torch.cuda.synchronize()
    us = dict.fromkeys(SSD_PASSES, 0.0)
    count = dict.fromkeys(SSD_PASSES, 0)
    for evt in prof.key_averages():
        for name in SSD_PASSES:
            if name in evt.key:
                us[name] += evt.device_time_total
                count[name] += evt.count
    if any(count[name] != reps or us[name] <= 0 for name in SSD_PASSES):
        raise AssertionError(f"the profiler saw passes {count} with device "
                             f"time {us} over {reps} calls")
    return {name: us[name] / reps / 1e3 for name in SSD_PASSES}


SSD_CHECKS = [  # name, b, s, h, p, n, chunk
    ("chunk 64", 1, 2048, 16, 64, 128, 64),
    ("chunk 128", 1, 2048, 16, 64, 128, 128),
    ("s < chunk (chunk = s = 200)", 1, 200, 16, 64, 128, 256),
    ("B=2", 2, 1024, 8, 64, 128, 256),
    ("N=P=16 chunk 16 (mamba2-smoke)", 2, 512, 8, 16, 16, 16),
    ("N=P=16 ragged chunk 100", 1, 300, 4, 16, 16, 100),
]
# The main path's call: one layer of the 8192-token mamba2-1.3b prefill.
SSD_MAIN = ("main path S=8192", 1, PREFILL_LEN, 64, 64, 128, 256)


def ssd_cases(gen) -> list:
    """The ssd checks' inputs, (name, (x, dt, a_log, b, c), chunk) each, the
    main path's call last."""
    cases = [(name, ssd_inputs(b, s, h, p, n, gen), min(chunk, s))
             for name, b, s, h, p, n, chunk in SSD_CHECKS]
    # Decay stability (tests/test_kernels.py:200-210) at the nearest
    # instantiated (N, P) = (16, 16): dt = 10, a_log = 2.
    x, _, _, bm, cm = ssd_inputs(1, 128, 1, 16, 16, gen)
    dt = torch.full((1, 128, 1), 10.0, device="cuda")
    a_log = torch.full((1,), 2.0, device="cuda")
    cases.append(("decay stability dt=10 a_log=2",
                  (x, dt, a_log, bm * 4.0, cm * 4.0), 64))  # N(0, 1), as there
    name, b, s, h, p, n, chunk = SSD_MAIN
    cases.append((name, ssd_inputs(b, s, h, p, n, gen, model_a_log=True),
                  chunk))
    return cases


def ssd_checks() -> dict:
    gen = generator(SEED + 2, "cuda")
    checks = []

    def check(name, args, chunk):
        y = ssd_kernel.ssd(*args, chunk=chunk)
        torch.cuda.synchronize()
        err = check_close(f"ssd {name} vs chunked", y,
                          ssd_ref.ssd_chunked(*args, chunk=chunk), **SSD_TOL)
        err_exact = check_close(f"ssd {name} vs exact scan", y,
                                ssd_ref.ssd_scan_ref(*args), **SSD_EXACT_TOL)
        checks.append({"case": name, "chunk": chunk, "max_abs_err": err,
                       "tol": SSD_TOL, "max_abs_err_exact": err_exact,
                       "tol_exact": SSD_EXACT_TOL})
        phase("kernel", kernel="ssd", case=repr(name), dtype="float32",
              design=repr(DESIGN["ssd"][torch.float32]),
              max_abs_err=f"{err:.3e}", tol=SSD_TOL,
              max_abs_err_exact=f"{err_exact:.3e}", tol_exact=SSD_EXACT_TOL)
        return y, err

    *edges, (name, args, chunk) = ssd_cases(gen)
    for case in edges:
        check(*case)
    y, err = check(name, args, chunk)
    for other in (64, 128):
        chunk_err = check_close(f"ssd {name} chunk {other} vs {chunk}",
                                ssd_kernel.ssd(*args, chunk=other), y,
                                **SSD_CHUNK_TOL)
        checks.append({"case": f"{name} chunk {other} vs {chunk}",
                       "max_abs_err": chunk_err, "tol": SSD_CHUNK_TOL})
        phase("kernel", kernel="ssd", case=repr(f"{name} chunk {other}"),
              max_abs_err_vs_chunk_256=f"{chunk_err:.3e}", tol=SSD_CHUNK_TOL)
    del y
    kernel_ms = cuda_ms(lambda: ssd_kernel.ssd(*args, chunk=chunk), reps=20,
                        warmup=2)
    plain_ms = cuda_ms(lambda: ssd_ref.ssd_chunked(*args, chunk=chunk),
                       reps=3)
    # The kernel's floor is its three TF32 products on the tensor cores; the
    # fp32 CUDA-core bound (what an fp32 FMA kernel could reach) beside it.
    _, b, s, h, p, n, _ = SSD_MAIN
    flops, nbytes = ssd_work(b, s, h, p, n, chunk)
    bnd, bound_by = bound_ms(flops, nbytes, "3xtf32")
    bnd_fp32, _ = bound_ms(flops, nbytes, torch.float32)
    design = DESIGN["ssd"][torch.float32]
    phase("kernel", kernel="ssd", case=repr(name), dtype="float32",
          design=repr(design), kernel_ms=f"{kernel_ms:.4f}",
          plain_ms=f"{plain_ms:.4f}", library_ms=None,
          bound_ms=f"{bnd:.4f}", bound_by=bound_by,
          bound_fp32_cuda_cores_ms=f"{bnd_fp32:.4f}",
          tflops=f"{flops / kernel_ms / 1e9:.2f}")
    passes = ssd_pass_ms(args, chunk)
    print("[kernel] ssd passes " + " ".join(
        [f"case={name!r}"] + [f"{k}_ms={v:.4f}" for k, v in passes.items()]
        + [f"sum_ms={sum(passes.values()):.4f}"]), flush=True)
    del args
    torch.cuda.empty_cache()
    return {"name": "ssd", "route": "cuda", "source": "src/repro_torch/csrc/ssd.cu",
            "replaces": "src/repro/kernels/ssd/kernel.py:78",
            "launches": None, "max_abs_err": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": bound_by,
            # no single PyTorch call computes the SSD scan
            "library_ms": None, "design": design, "passes_ms": passes,
            "shape": {"b": b, "s": s, "h": h, "p": p, "n": n, "chunk": chunk,
                      "dtype": "float32"},
            "checks": checks}


# --------------------------------------------------- phase 3: matmul, rmsnorm

def bound_ms(flops: float, nbytes: float, dtype) -> tuple:
    """The larger of the operations over the peak rate of ``dtype`` (a
    ``PEAK_FLOPS`` key) on the CUDA cores or tensor cores, and the bytes
    over HBM's rate."""
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    return max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def bits(t):
    """The tensor's bits, so that equality means the same bits."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def same_bits_from_every_tile(what: str, a, b):
    """Every instantiated tile for ``a``'s dtype on the same inputs: raises
    unless all give the same bits; returns (the first tile's output, the
    plain version's)."""
    tiles = mm_kernel.TILES[a.dtype]
    outs = [mm_kernel.matmul_tiled(a, b, bm=bm, bn=bn) for bm, bn in tiles]
    torch.cuda.synchronize()
    for tile, out in zip(tiles[1:], outs[1:]):
        if not torch.equal(bits(out), bits(outs[0])):
            raise AssertionError(f"{what}: tile {tile} differs in its bits "
                                 f"from tile {tiles[0]}")
    return outs[0], mm_ref.matmul(a, b)


MM_CHECKS = [(8, 8, 8), (64, 64, 8), (100, 257, 1000), (129, 4097, 257),
             (4095, 4097, 129), (256, 256, 8192)]
MM_PLAIN = (4, 512, 512)        # min(m, n, k) < 8: ops takes the plain version
MM_SUITE = [(n, n, n) for n in microbench.CARD.gemm_kernels]
MM_MAIN = (8192, 8192, 8192)    # the suite's largest hand-written case


def matmul_checks() -> dict:
    gen = generator(SEED + 3, "cuda")
    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        tol = MM_RMS_TOL[dtype]
        tiles = mm_kernel.TILES[dtype]
        for m, n, k in MM_CHECKS + MM_SUITE:
            a = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
            b = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
            first, plain = same_bits_from_every_tile(
                f"matmul {(m, n, k)} {dtype}", a, b)
            err = check_close(f"matmul {(m, n, k)} {dtype}", first, plain,
                              atol=tol * k ** 0.5, rtol=tol)
            check = {"case": [m, n, k], "dtype": str(dtype)[6:],
                     "max_abs_err": err, "tol": tol,
                     "tiles_bit_identical": [list(t) for t in tiles]}
            if dtype == torch.float32:
                # A second witness: the fp64 product of the same inputs,
                # which tells the kernel's error from cuBLAS's own.
                exact = torch.matmul(a.double(), b.double())
                check["max_abs_err_vs_fp64"] = check_close(
                    f"matmul {(m, n, k)} fp32 vs fp64", first, exact,
                    atol=tol * k ** 0.5, rtol=tol)
                check["plain_max_abs_err_vs_fp64"] = max_abs_err(
                    f"plain matmul {(m, n, k)}", plain, exact)
                del exact
            checks.append(check)
            phase("kernel", kernel="matmul", case=[m, n, k],
                  dtype=str(dtype)[6:], design=repr(DESIGN["matmul"][dtype]),
                  max_abs_err=f"{err:.3e}",
                  atol=f"{tol * k ** 0.5:.3e}", rtol=tol,
                  tiles_bit_identical=len(tiles),
                  **{key: f"{check[key]:.3e}" for key in
                     ("max_abs_err_vs_fp64", "plain_max_abs_err_vs_fp64")
                     if key in check})
            del a, b, first, plain
        m, n, k = MM_PLAIN
        a = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
        b = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
        before = mm_kernel.launches
        got = matmul(a, b)
        if mm_kernel.launches != before:
            raise AssertionError(f"matmul {MM_PLAIN}: the op launched the "
                                 f"kernel for a product with m < 8")
        check_close(f"matmul {MM_PLAIN} {dtype}", got, mm_ref.matmul(a, b),
                    atol=tol * k ** 0.5, rtol=tol)
        phase("kernel", kernel="matmul", case=list(MM_PLAIN),
              dtype=str(dtype)[6:], path="plain (min(m, n, k) < 8)")
    torch.cuda.empty_cache()

    m, n, k = MM_MAIN
    dtype = torch.float32
    a = torch.randn((m, k), generator=gen, device="cuda")
    b = torch.randn((k, n), generator=gen, device="cuda")
    err = check_close(f"matmul main {MM_MAIN}", mm_kernel.matmul_tiled(a, b),
                      mm_ref.matmul(a, b), atol=MM_RMS_TOL[dtype] * k ** 0.5,
                      rtol=MM_RMS_TOL[dtype])
    kernel_ms = cuda_ms(lambda: mm_kernel.matmul_tiled(a, b), reps=5,
                        warmup=1)
    plain_ms = cuda_ms(lambda: mm_ref.matmul(a, b), reps=5, warmup=1)
    # Yardstick only (the port's kernel never calls it): cuBLAS, TF32 off.
    library_ms = cuda_ms(lambda: torch.matmul(a, b), reps=5, warmup=1)
    flops = 2.0 * m * n * k
    # The kernel's floor is its three TF32 products on the tensor cores; the
    # fp32 CUDA-core bound (what an fp32 FMA kernel could reach) beside it.
    bnd, bound_by = bound_ms(flops, 4.0 * (m * k + k * n + m * n), "3xtf32")
    bnd_fp32, _ = bound_ms(flops, 4.0 * (m * k + k * n + m * n), dtype)
    design = DESIGN["matmul"][dtype]
    phase("kernel", kernel="matmul", case=list(MM_MAIN), dtype="float32",
          design=repr(design), default_tile=mm_kernel.hopper_tile(m, n),
          kernel_ms=f"{kernel_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
          library_ms=f"{library_ms:.4f}", bound_ms=f"{bnd:.4f}",
          bound_by=bound_by, bound_fp32_cuda_cores_ms=f"{bnd_fp32:.4f}",
          tflops=f"{flops / kernel_ms / 1e9:.2f}")
    del a, b
    torch.cuda.empty_cache()

    # bf16 at the same shape: the kernel against cuBLAS's bf16 product.
    a = torch.randn((m, k), generator=gen, device="cuda").bfloat16()
    b = torch.randn((k, n), generator=gen, device="cuda").bfloat16()
    err16 = check_close(f"matmul main {MM_MAIN} bf16",
                        mm_kernel.matmul_tiled(a, b), mm_ref.matmul(a, b),
                        atol=MM_RMS_TOL[torch.bfloat16] * k ** 0.5,
                        rtol=MM_RMS_TOL[torch.bfloat16])
    ms16 = cuda_ms(lambda: mm_kernel.matmul_tiled(a, b), reps=10, warmup=2)
    plain16 = cuda_ms(lambda: mm_ref.matmul(a, b), reps=3, warmup=1)
    lib16 = cuda_ms(lambda: torch.matmul(a, b), reps=10, warmup=2)
    bnd16, by16 = bound_ms(flops, 2.0 * (m * k + k * n + m * n),
                           torch.bfloat16)
    design16 = DESIGN["matmul"][torch.bfloat16]
    phase("kernel", kernel="matmul", case=list(MM_MAIN), dtype="bfloat16",
          design=repr(design16), max_abs_err=f"{err16:.3e}",
          kernel_ms=f"{ms16:.4f}", plain_ms=f"{plain16:.4f}",
          library_ms=f"{lib16:.4f}", bound_ms=f"{bnd16:.4f}", bound_by=by16,
          tflops=f"{flops / ms16 / 1e9:.2f}")
    del a, b
    torch.cuda.empty_cache()
    return {"name": "matmul", "route": "cuda",
            "source": "src/repro_torch/csrc/matmul.cu",
            "replaces": "src/repro/kernels/matmul/kernel.py:46",
            "launches": None, "max_abs_err": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": bound_by,
            "library_ms": library_ms, "design": design,
            "shape": {"m": m, "n": n, "k": k, "dtype": "float32",
                      "tile": mm_kernel.hopper_tile(m, n)},
            "bf16": {"design": design16, "max_abs_err": err16, "ms": ms16,
                     "plain_ms": plain16, "library_ms": lib16,
                     "bound_ms": bnd16, "bound_by": by16},
            "checks": checks}


RMS_ROWS = (1, 100, 65536)
RMS_DIMS = (8, 64, 1024, 2560, 8192, 16384)   # every path of the kernel
RMS_LEAD = (4, 2048, 2560)      # ops flattens the leading dims
RMS_MAIN = (65536, 2560)        # the suite's rmsnorm_kernel case


def rmsnorm_checks() -> dict:
    gen = generator(SEED + 4, "cuda")
    checks = []
    for dtype in (torch.float32, torch.bfloat16):
        tol = MM_RMS_TOL[dtype]
        shapes = [(r, d) for r in RMS_ROWS for d in RMS_DIMS] + [RMS_LEAD]
        for shape in shapes:
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            w = torch.randn(shape[-1], generator=gen, device="cuda").to(dtype)
            before = rms_kernel.launches
            got = rmsnorm(x, w)
            torch.cuda.synchronize()
            if rms_kernel.launches != before + 1:
                raise AssertionError(f"rmsnorm {shape}: the op did not "
                                     f"launch the kernel")
            err = check_close(f"rmsnorm {shape} {dtype}", got,
                              rms_ref.rmsnorm(x, w), atol=tol, rtol=tol)
            checks.append({"case": list(shape), "dtype": str(dtype)[6:],
                           "max_abs_err": err, "tol": tol})
            phase("kernel", kernel="rmsnorm", case=list(shape),
                  dtype=str(dtype)[6:], max_abs_err=f"{err:.3e}", tol=tol)
            del x, w, got
    torch.cuda.empty_cache()

    r, d = RMS_MAIN
    timed = {}
    for dtype in (torch.bfloat16, torch.float32):
        x = torch.randn((r, d), generator=gen, device="cuda").to(dtype)
        w = torch.randn(d, generator=gen, device="cuda").to(dtype)
        err = check_close(f"rmsnorm main {RMS_MAIN} {dtype}",
                          rms_kernel.rmsnorm_2d(x, w), rms_ref.rmsnorm(x, w),
                          atol=MM_RMS_TOL[dtype], rtol=MM_RMS_TOL[dtype])
        kernel_ms = cuda_ms(lambda: rms_kernel.rmsnorm_2d(x, w), reps=20,
                            warmup=2)
        plain_ms = cuda_ms(lambda: rms_ref.rmsnorm(x, w), reps=5, warmup=1)
        # Yardstick only (the port never calls it).
        library_ms = cuda_ms(lambda: torch.nn.functional.rms_norm(
            x, (d,), w, 1e-6), reps=20, warmup=2)
        size = x.element_size()
        bnd, bound_by = bound_ms(4.0 * r * d, size * (2.0 * r * d + d),
                                 torch.float32)
        phase("kernel", kernel="rmsnorm", case=list(RMS_MAIN),
              dtype=str(dtype)[6:], max_abs_err=f"{err:.3e}",
              kernel_ms=f"{kernel_ms:.4f}", plain_ms=f"{plain_ms:.4f}",
              library_ms=f"{library_ms:.4f}", bound_ms=f"{bnd:.4f}",
              bound_by=bound_by,
              gb_per_s=f"{size * 2.0 * r * d / kernel_ms / 1e6:.1f}")
        timed[dtype] = (err, kernel_ms, plain_ms, library_ms, bnd, bound_by)
        del x, w
    torch.cuda.empty_cache()
    err, kernel_ms, plain_ms, library_ms, bnd, bound_by = timed[torch.float32]
    err16, ms16, plain16, lib16, bnd16, _ = timed[torch.bfloat16]
    return {"name": "rmsnorm", "route": "cuda",
            "source": "src/repro_torch/csrc/rmsnorm.cu",
            "replaces": "src/repro/kernels/rmsnorm/kernel.py:31",
            "launches": None, "max_abs_err": err, "ms": kernel_ms,
            "plain_ms": plain_ms, "bound_ms": bnd, "bound_by": bound_by,
            "library_ms": library_ms,
            "shape": {"rows": r, "d": d, "dtype": "float32"},
            "bf16": {"max_abs_err": err16, "ms": ms16, "plain_ms": plain16,
                     "library_ms": lib16, "bound_ms": bnd16},
            "checks": checks}


# ------------------------------------------------------ phase: the loop

# calibrate_device runs per loop phase: two alone, then validate_device's
# own, so each parameter's spread between runs on one card is printed
# beside the ladder (the package takes one calibration, as the reference).
CALIBRATIONS = 3
# The vector chain counts as FLOP-bound above this share of the fp32 peak.
# At 128 flops a byte a bandwidth-bound run could pass the fp32 peak, so
# HBM's rate bounds nothing; a chain that fell back to the memory system
# (the reference's 4 FMAs: 1 flop a byte, ~3e12) or lost its fusion lands
# far under the floor.  Sound runs on the H100 read 81-86% of the peak.
VECTOR_FLOOR_SHARE = 0.5


def measured_params(hw) -> dict:
    return {"fp32_matrix_flops": hw.sustained_flops("fp32", matrix=True),
            "fp32_vector_flops": hw.sustained_flops("fp32", matrix=False),
            "hbm_bytes_per_s": hw.hbm_sustained_bw,
            "launch_latency_s": hw.launch_latency_s}


def check_physical(hw) -> None:
    """Full-fp32 products cannot beat the CUDA cores' peak (a TF32 product
    would); no stream beats HBM's rate; the vector chain is FLOP-bound: its
    rate is above ``VECTOR_FLOOR_SHARE`` of the fp32 peak, and below the
    peak (above it, the compiler removed work)."""
    p = measured_params(hw)
    for key, value in p.items():
        if not (value > 0 and value < float("inf")):
            raise AssertionError(f"measured {key} = {value}")
    if p["fp32_matrix_flops"] > PEAK_FLOPS[torch.float32]:
        raise AssertionError("fp32 GEMM faster than the fp32 peak: TF32 on?")
    if p["hbm_bytes_per_s"] > HBM_BYTES_PER_S:
        raise AssertionError("stream bandwidth above HBM's rate")
    floor = VECTOR_FLOOR_SHARE * PEAK_FLOPS[torch.float32]
    if not p["fp32_vector_flops"] > floor:
        raise AssertionError(f"vector rate {p['fp32_vector_flops']:.4g} not "
                             f"above {floor:.4g} ({VECTOR_FLOOR_SHARE} of "
                             f"the fp32 peak): the chain is not FLOP-bound")
    if p["fp32_vector_flops"] > PEAK_FLOPS[torch.float32]:
        raise AssertionError("vector chain faster than the fp32 peak: the "
                             "compiled chain lost work")


def loop(entries: dict):
    """The paper's loop at the card's sizes, through the entry point a user
    calls, after ``CALIBRATIONS - 1`` calibrations alone.  Records the
    matmul and rmsnorm launch counts of this run in their entries; returns
    the measured parameters the ladder used."""
    sz = microbench.CARD
    runs = 1 + sz.warmups + sz.repeats      # a first call, then the timed
    want = {"flash_attention": 0, "ssd": 0,
            "matmul": len(sz.gemm_kernels) * runs, "rmsnorm": runs}
    t0 = time.perf_counter()
    reset_launches()
    calibrated, calib_secs = [], []
    for _ in range(CALIBRATIONS - 1):
        c0 = time.perf_counter()
        calibrated.append(microbench.calibrate_device(quick=False))
        torch.cuda.synchronize()
        calib_secs.append(time.perf_counter() - c0)
    v0 = time.perf_counter()
    hw, lad = validate_device(quick=False)
    torch.cuda.synchronize()
    launches = read_launches()
    secs = time.perf_counter() - t0
    validate_secs = time.perf_counter() - v0
    check_launches("the loop", launches, want)
    for name in ("matmul", "rmsnorm"):
        entries[name]["launches"] = launches[name]
    calibrated.append(hw)
    for run in calibrated:
        check_physical(run)

    sheet = measured_params(hardware.get("h100"))
    for key, measured in measured_params(hw).items():
        phase("loop", parameter=key, measured=f"{measured:.6g}",
              datasheet_h100=f"{sheet[key]:.6g}",
              ratio=f"{measured / sheet[key]:.4f}")
    for key in sheet:
        vals = sorted(measured_params(run)[key] for run in calibrated)
        med = vals[len(vals) // 2]
        phase("loop", spread=key, runs=len(vals), median=f"{med:.6g}",
              min=f"{vals[0]:.6g}", max=f"{vals[-1]:.6g}",
              range_pct=f"{(vals[-1] - vals[0]) / med * 100:.2f}",
              values=[f"{measured_params(run)[key]:.6g}"
                      for run in calibrated])
    fpb = microbench.vector_chain_flops(1, sz.calib_vector_fmas) / 8.0
    vec = measured_params(hw)["fp32_vector_flops"]
    bw = measured_params(hw)["hbm_bytes_per_s"]
    phase("loop", vector_chain_fmas=sz.calib_vector_fmas,
          flops_per_byte=fpb, rate=f"{vec:.6g}",
          bandwidth_ceiling=f"{fpb * bw:.6g}",
          floor=f"{VECTOR_FLOOR_SHARE * PEAK_FLOPS[torch.float32]:.6g}",
          fp32_peak=f"{PEAK_FLOPS[torch.float32]:.6g}",
          share_of_peak=f"{vec / PEAK_FLOPS[torch.float32]:.4f}",
          calibrate_seconds=[round(t, 1) for t in calib_secs],
          validate_device_seconds=f"{validate_secs:.1f}")

    if len(lad.suite) != 12:
        raise AssertionError(f"suite has {len(lad.suite)} cases, want 12")
    for row in lad.rows():
        for key in ("measured_us", "model_us"):
            if not (row[key] > 0 and row[key] < float("inf")):
                raise AssertionError(f"loop row {row}")
        phase("loop", **{k: row[k] for k in (
            "kernel", "class", "measured_us", "model_us", "model_err_pct",
            "roofline_err_pct", "base_model_err_pct")})
    maes = lad.maes()
    for rung, pair in maes.items():
        phase("loop", mae=rung, model_pct=f"{pair['model']:.3f}",
              roofline_pct=f"{pair['roofline']:.3f}")
    if maes["per_case"]["model"] > 1e-6:
        raise AssertionError(f"per-case calibration leaves "
                             f"{maes['per_case']['model']}% MAE")
    phase("loop", launches=launches, seconds=f"{secs:.1f}",
          derived=repr(lad.derived()))
    torch.cuda.empty_cache()
    return hw


# ------------------------------------------------------ phase: tile selection

# The paper's adaptive tile selection (§IV-B) on the card: the loop's
# gemm_kernel sizes, and h2o-danube-1.8b's prefill projections at S = 8192
# (q/o (2560, 2560), MLP up (2560, 6912), down (6912, 2560); the model runs
# them through torch.matmul, as the reference through einsum: here they are
# only shapes to pick tiles for).
TILE_SHAPES = [((4096, 4096, 4096), torch.float32),
               ((8192, 8192, 8192), torch.float32),
               ((8192, 8192, 8192), torch.bfloat16),
               ((PREFILL_LEN, 2560, 2560), torch.bfloat16),
               ((PREFILL_LEN, 6912, 2560), torch.bfloat16),
               ((PREFILL_LEN, 2560, 6912), torch.bfloat16)]
TILE_REPS, TILE_WARMUP = 5, 1


def ranks(xs) -> list:
    """Ranks from 1, ties given their mean rank."""
    order = sorted(range(len(xs)), key=lambda i: xs[i])
    out = [0.0] * len(xs)
    i = 0
    while i < len(order):
        j = i
        while j + 1 < len(order) and xs[order[j + 1]] == xs[order[i]]:
            j += 1
        for idx in order[i:j + 1]:
            out[idx] = (i + j) / 2.0 + 1.0
        i = j + 1
    return out


def rank_correlation(xs, ys) -> float:
    """Spearman's rho: Pearson's correlation of the ranks."""
    rx, ry = ranks(xs), ranks(ys)
    mx, my = sum(rx) / len(rx), sum(ry) / len(ry)
    cov = sum((a - mx) * (b - my) for a, b in zip(rx, ry))
    var = (sum((a - mx) ** 2 for a in rx) * sum((b - my) ** 2 for b in ry))
    return cov / var ** 0.5 if var > 0 else float("nan")


def tile_selection(measured_hw, entries: dict) -> None:
    """For each shape, the model's price of every instantiated tile
    (``select_blocks``: fp32 on the measured parameters, bf16 on the
    datasheet file, which ``calibrate_device`` does not measure) beside the
    tile's time (CUDA events, mean of ``TILE_REPS`` after a warm-up); every
    tile checked against the plain version and bit for bit against the
    others.  Regret: the measured time of the model's pick over the best
    measured time, minus 1.  Nothing is gated on it."""
    gen = generator(SEED + 5, "cuda")
    sheet = hardware.get("h100")
    want = sum(len(mm_kernel.TILES[dtype]) * (1 + TILE_WARMUP + TILE_REPS)
               for _, dtype in TILE_SHAPES)
    reset_launches()
    summary = []
    for (m, n, k), dtype in TILE_SHAPES:
        precision = {torch.float32: "fp32", torch.bfloat16: "bf16"}[dtype]
        hw = measured_hw if dtype == torch.float32 else sheet
        pick, costs = mm_ops.select_blocks(m, n, k, precision=precision,
                                           hw=hw)
        a = torch.randn((m, k), generator=gen, device="cuda").to(dtype)
        b = torch.randn((k, n), generator=gen, device="cuda").to(dtype)
        what = f"tiles {(m, n, k)} {precision}"
        out, plain = same_bits_from_every_tile(what, a, b)
        tol = MM_RMS_TOL[dtype]
        err = check_close(what, out, plain, atol=tol * k ** 0.5, rtol=tol)
        del out, plain
        blocks = list(costs)
        ms = [cuda_ms(lambda bm=bm, bn=bn: mm_kernel.matmul_tiled(
                  a, b, bm=bm, bn=bn), reps=TILE_REPS, warmup=TILE_WARMUP)
              for bm, bn, _ in blocks]
        model_us = [costs[c] * 1e6 for c in blocks]
        for c, mod, meas in zip(blocks, model_us, ms):
            phase("tiles", shape=[m, n, k], dtype=precision,
                  tile=f"{c[0]}x{c[1]}x{c[2]}", model_us=f"{mod:.1f}",
                  measured_us=f"{meas * 1e3:.1f}")
        best = blocks[min(range(len(ms)), key=ms.__getitem__)]
        regret = ms[blocks.index(pick)] / min(ms) - 1.0
        rho = rank_correlation(model_us, ms)
        phase("tiles", shape=[m, n, k], dtype=precision, params=hw.name,
              model_pick=f"{pick[0]}x{pick[1]}", measured_best=f"{best[0]}x"
              f"{best[1]}", regret=f"{regret:.4f}", rank_corr=f"{rho:.3f}",
              max_abs_err=f"{err:.3e}", tiles_bit_identical=len(blocks))
        # The kernels line carries measured times only; the model's prices
        # and what follows from them stay on the [tiles] lines.
        summary.append({"shape": [m, n, k], "dtype": precision,
                        "measured_ms": dict(zip([f"{c[0]}x{c[1]}"
                                                 for c in blocks], ms)),
                        "measured_best": list(best[:2])})
        del a, b
        torch.cuda.empty_cache()
    launches = read_launches()
    check_launches("tile selection", launches,
                   {"flash_attention": 0, "ssd": 0, "matmul": want,
                    "rmsnorm": 0})
    phase("tiles", launches=launches)
    entries["matmul"]["tile_selection"] = summary


# ----------------------------------------------------------------- phase 4

def prefill_requests(arch: str, entries: dict) -> None:
    """The main path of ``arch``: fp32 kernel path against the plain path,
    then the bf16 request counted and timed.  Records each kernel's launch
    count of the counted run in its entry."""
    cfg = get_config(arch).replace(use_flash_kernel=True)
    want = expected_launches(cfg)
    tokens = torch.randint(0, cfg.vocab, (1, PREFILL_LEN),
                           generator=generator(SEED + 1, "cuda"),
                           device="cuda")

    # fp32: the kernel path against the plain path (danube: attn_chunk=1024
    # -> _sdpa_chunked; mamba2: ssd_chunked), tight tolerance.
    cfg32 = cfg.replace(dtype="float32", param_dtype="float32")
    model = build(cfg32, "cuda").init(generator(SEED, "cuda"))
    prefill = make_prefill(model)
    reset_launches()
    logits_k = prefill(tokens)
    torch.cuda.synchronize()
    launches32 = read_launches()
    check_launches(f"{arch} fp32 prefill", launches32, want)
    model.cfg = cfg32.replace(use_flash_kernel=False)
    logits_p = prefill(tokens)
    err32 = check_close(f"{arch} fp32 prefill logits, kernel vs plain",
                        logits_k, logits_p, atol=FP32_REQUEST_TOL,
                        rtol=FP32_REQUEST_TOL)
    phase("prefill", arch=arch, dtype="float32", tokens=PREFILL_LEN,
          launches=launches32, max_abs_err=f"{err32:.3e}",
          tol=FP32_REQUEST_TOL,
          logits_absmax=f"{logits_p.abs().max().item():.3f}")
    del model, prefill, logits_k, logits_p
    torch.cuda.empty_cache()

    # bf16: the served dtype.  The counted run is the main path's run.
    torch.cuda.reset_peak_memory_stats()
    model = build(cfg, "cuda").init(generator(SEED, "cuda"))
    prefill = make_prefill(model)
    prefill(tokens)                                   # warm-up
    logits_k = None

    def request():
        nonlocal logits_k
        logits_k = prefill(tokens)
    reset_launches()
    first_ms = host_ms(request)
    launches = read_launches()
    check_launches(f"{arch} bf16 prefill", launches, want)
    for name, n in want.items():
        if n:
            entries[name]["launches"] = launches[name]
    kernel_req_ms = sorted([first_ms] + [host_ms(request) for _ in range(2)])
    model.cfg = cfg.replace(use_flash_kernel=False)
    logits_p = None

    def plain_request():
        nonlocal logits_p
        logits_p = prefill(tokens)
    plain_req_ms = sorted(host_ms(plain_request) for _ in range(3))
    what = f"{arch} bf16 prefill logits, kernel vs plain"
    if BF16_GATED[arch]:
        tol16 = BF16_REQUEST_TOL
        err16 = check_close(what, logits_k, logits_p, **tol16)
    else:
        tol16 = "not gated (see BF16_GATED)"
        err16 = max_abs_err(what, logits_k, logits_p)
    phase("prefill", arch=arch, dtype="bfloat16", tokens=PREFILL_LEN,
          launches=launches, request_ms=[round(t, 3) for t in kernel_req_ms],
          plain_request_ms=[round(t, 3) for t in plain_req_ms],
          max_abs_err=f"{err16:.3e}", tol=tol16,
          peak_mem_gb=round(torch.cuda.max_memory_allocated() / 1e9, 2))
    del model, prefill, logits_k, logits_p
    torch.cuda.empty_cache()


# ----------------------------------------------------------------- phase 5

def generation_request(arch: str) -> None:
    reset_launches()
    out = serve(arch, smoke=False, batch=GEN_BATCH, prompt_len=GEN_PROMPT,
                max_new=GEN_NEW, seed=SEED, device="cuda")
    torch.cuda.synchronize()
    gen_launches = read_launches()     # greedy decoding reaches no kernel
    check_launches(f"{arch} generation", gen_launches,
                   {name: 0 for name in KERNELS})
    vocab = get_config(arch).vocab
    if tuple(out.shape) != (GEN_BATCH, GEN_NEW) or out.dtype != torch.int32:
        raise AssertionError(f"tokens {tuple(out.shape)} {out.dtype}")
    if not bool(((out >= 0) & (out < vocab)).all()):
        raise AssertionError("token ids out of range")

    model, prompt = setup(arch, smoke=False, batch=GEN_BATCH,
                          prompt_len=GEN_PROMPT, seed=SEED, device="cuda")
    check_dtype = PROMPT_CHECK_DTYPE[arch]
    if check_dtype == torch.float32:
        checked = build(model.cfg.replace(dtype="float32",
                                          param_dtype="float32"), "cuda")
        checked.load_state_dict(model.state_dict())
        tol = {"atol": FP32_REQUEST_TOL, "rtol": FP32_REQUEST_TOL}
    else:
        checked, tol = model, BF16_REQUEST_TOL
    cfg = checked.cfg
    checked.cfg = cfg.replace(use_flash_kernel=True)
    last_fast = make_prefill(checked)(prompt)
    checked.cfg = cfg
    with torch.inference_mode():
        last_seq, _ = checked.prefill(
            prompt, checked.init_cache(GEN_BATCH, GEN_PROMPT))
    err = check_close(f"{arch} prompt logits, make_prefill vs sequential "
                      f"prefill", last_fast, last_seq, **tol)
    del checked, last_fast, last_seq
    toks = None

    def generate():
        nonlocal toks
        toks = greedy_generate(model, prompt, max_new=GEN_NEW)
    gen_ms = host_ms(generate)
    phase("generate", arch=arch, batch=GEN_BATCH, prompt=GEN_PROMPT,
          new=GEN_NEW, kernel_launches=gen_launches,
          prompt_logits_dtype=str(check_dtype)[6:],
          prompt_logits_err=f"{err:.3e}", tol=tol,
          request_ms=f"{gen_ms:.1f}",
          tok_per_s=f"{GEN_BATCH * GEN_NEW / gen_ms * 1e3:.1f}",
          same_tokens_as_serve=bool(torch.equal(toks, out)))
    del model, prompt
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is visible; nothing was run",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    machine()
    build_kernels()
    entries = {"flash_attention": flash_attention_checks(),
               "ssd": ssd_checks(), "matmul": matmul_checks(),
               "rmsnorm": rmsnorm_checks()}
    measured_hw = loop(entries)
    tile_selection(measured_hw, entries)
    for arch in (DANUBE, MAMBA2):
        prefill_requests(arch, entries)
        generation_request(arch)
    print(json.dumps({"kernels": list(entries.values())}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
