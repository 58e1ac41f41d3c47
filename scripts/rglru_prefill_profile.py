#!/usr/bin/env python3
"""Where one bf16 prefill request of recurrentgemma-9b goes on one NVIDIA
Hopper card: full width and depth (38 layers, 26 RG-LRU and 12 local
attention blocks, d 4096, lru width 4096, 16 query heads on 1 kv head of
256, window 2048, vocab 256,000), B = 1, S = 8192 as ``chip_smoke.py``'s
prefill phase serves it (``chip_smoke.PREFILL``), with the flash kernel on
(one launch a local-attention block), weights from seed 0 and the prompt
from seed 1, as there.

After two warm-up requests of ``train.serve_step.make_prefill``:

- the request on the host clock, ending in a synchronise (median of 3);
- one request under ``torch.profiler`` (CPU and CUDA activities), with the
  RG-LRU's scan (``models.rglru._scan``) and its fp32
  block-diagonal gates (``models.rglru._gates``) wrapped in profiler
  ranges by this script: the card's busy time against the request's wall
  time (the idle share); the device time of the scan, of the gates, of the
  flash kernel (launched through ctypes, outside any aten op), of the
  weight products (``aten::mm``) and of everything else; the top aten
  ops and kernels by device time;
- the scan alone at one layer's shape, (1, 8192, 4096) fp32, by CUDA
  events (mean of 20 calls), beside its bound: a and u read once and h
  written once at the HBM rate.

    python3 scripts/rglru_prefill_profile.py

Prints the card's name and power limit, one line per measurement, and a
JSON object last.  Needs a card; builds the flash-attention kernel.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402,E501

from chip_smoke import (HBM_BYTES_PER_S, PREFILL, RG, SEED, cuda_ms,  # noqa: E402,E501
                        host_ms)
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.device import generator  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402,E501
from repro_torch.models import build, rglru  # noqa: E402
from repro_torch.train.serve_step import make_prefill  # noqa: E402

RANGES = {"scan": "rglru._scan", "gates": "rglru._gates"}


def ranged(name, fn):
    """``fn`` inside a profiler range named ``name``; the calls it makes to
    itself (the scan recurses) stay inside the outer range."""
    inside = [False]

    def wrapped(*args, **kwargs):
        if inside[0]:
            return fn(*args, **kwargs)
        inside[0] = True
        try:
            with record_function(name):
                return fn(*args, **kwargs)
        finally:
            inside[0] = False
    return wrapped


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    seq, served_cut, _ = PREFILL[RG]
    cfg = get_config(RG).replace(use_flash_kernel=True, **served_cut)
    model = build(cfg, "cuda").init(generator(SEED, "cuda"))
    tokens = torch.randint(0, cfg.vocab, (1, seq),
                           generator=generator(SEED + 1, "cuda"),
                           device="cuda")
    prefill = make_prefill(model)
    for _ in range(2):
        prefill(tokens)
    ms = statistics.median(host_ms(lambda: prefill(tokens))
                           for _ in range(3))
    print(f"[profile] request host ms (median of 3): {ms:.3f}", flush=True)

    n_attn = cfg.n_groups * cfg.pattern.count("local_attn")
    n_lru = cfg.n_groups * cfg.pattern.count("rglru")
    real = {key: getattr(rglru, "_" + key) for key in RANGES}
    for key, name in RANGES.items():
        setattr(rglru, "_" + key, ranged(name, real[key]))
    fa_kernel.launches = 0
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            prefill(tokens)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        for key in RANGES:
            setattr(rglru, "_" + key, real[key])
    if fa_kernel.launches != n_attn:
        raise AssertionError(f"flash launches {fa_kernel.launches}, want "
                             f"{n_attn}")
    events = prof.key_averages()
    # The profiler also puts each range on the device's timeline; those
    # spans are not kernels.
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.key not in RANGES.values()]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    print(f"[profile] request wall {wall_ms:.3f} ms (profiled), device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}",
          flush=True)

    # The ranges' device time: every kernel launched inside them.  The
    # gates' block-diagonal einsum runs as a batched product (aten::bmm),
    # so aten::mm is the weight products alone.
    cpu = {e.key: e for e in events if e.device_type == DeviceType.CPU}
    parts = {}
    for key, name in RANGES.items():
        e = cpu.get(name)
        if e is None or e.count != n_lru or e.device_time_total <= 0:
            raise AssertionError(f"range {name}: {e and e.count} calls, "
                                 f"{e and e.device_time_total} us; want "
                                 f"{n_lru} calls with device time")
        parts[key] = e.device_time_total / 1e3
    parts["weight products (mm)"] = cpu["aten::mm"].self_device_time_total \
        / 1e3
    parts["flash kernel"] = sum(e.self_device_time_total for e in kernels
                                if "attn_fwd" in e.key) / 1e3
    parts["other"] = busy_ms - sum(parts.values())
    for name, t in sorted(parts.items(), key=lambda kv: -kv[1]):
        print(f"[profile] part {name}: {t:.3f} ms ({t / busy_ms:.4f} of "
              f"busy)", flush=True)
    ops = [e for e in events if e.device_type == DeviceType.CPU
           and e.self_device_time_total > 0]
    top_ops = sorted(ops, key=lambda e: -e.self_device_time_total)[:15]
    for e in top_ops:
        print(f"[profile] op {e.key}: {e.self_device_time_total / 1e3:.3f} "
              f"ms, {e.count} calls", flush=True)
    top_kernels = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    for e in top_kernels:
        print(f"[profile] kernel {e.key[:90]}: "
              f"{e.self_device_time_total / 1e3:.3f} ms, {e.count} calls",
              flush=True)

    w = cfg.lru_width
    gen = generator(SEED + 3, "cuda")
    a = torch.rand((1, seq, w), generator=gen, device="cuda")
    u = torch.randn((1, seq, w), generator=gen, device="cuda")
    with torch.inference_mode():
        scan_ms = cuda_ms(lambda: rglru._scan(a, u), reps=20, warmup=2)
    nbytes = 3 * 4 * seq * w
    scan_bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"[profile] scan alone (1, {seq}, {w}) fp32: {scan_ms:.4f} ms, "
          f"bound {scan_bound_ms:.4f} ms (bytes: a, u read and h written "
          f"once)", flush=True)
    print(json.dumps({
        "arch": RG, "layers": cfg.n_layers, "rglru_layers": n_lru,
        "attn_layers": n_attn, "seq": seq, "host_ms_median3": ms,
        "profiled_wall_ms": wall_ms, "device_busy_ms": busy_ms,
        "idle_share": 1 - busy_ms / wall_ms, "parts_ms": parts,
        "scan_alone_ms": scan_ms, "scan_bound_ms": scan_bound_ms,
        "top_ops": [{"op": e.key, "ms": e.self_device_time_total / 1e3,
                     "calls": e.count} for e in top_ops],
        "top_kernels": [{"kernel": e.key, "ms": e.self_device_time_total
                         / 1e3, "calls": e.count} for e in top_kernels],
        "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
