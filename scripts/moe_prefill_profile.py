#!/usr/bin/env python3
"""Where one bf16 prefill request of qwen3-moe-235b-a22b goes on one NVIDIA
Hopper card: full width (d 4096, 64/4 heads of 128, 128 experts top-8 of
width 1536, vocab 151,936) at the depth cut and prompt length that
``chip_smoke.py``'s prefill phase serves (``chip_smoke.PREFILL``: 8 of 94
layers, B = 1, S = 8192), with the flash kernel on (one launch a layer),
weights from seed 0 and the prompt from seed 1, as there.

After two warm-up requests of ``train.serve_step.make_prefill``:

- the request on the host clock, ending in a synchronise (median of 3);
- one request under ``torch.profiler`` (CPU and CUDA activities): the
  card's busy time against the request's wall time (the idle share); the
  device time of each aten op (its own kernels), grouped as the expert
  products (``aten::bmm``), the weight products (``aten::mm``), the MoE
  dispatch (sorts, searches, gathers, scatters, masked selects, counts),
  and everything else; the device time of kernels launched outside any
  aten op (the hand-written flash-attention kernel, called through
  ctypes); and the top kernels by device time.

    python3 scripts/moe_prefill_profile.py

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
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from chip_smoke import PREFILL, QWEN3, SEED, host_ms  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.device import generator  # noqa: E402
from repro_torch.kernels.flash_attention import kernel as fa_kernel  # noqa: E402,E501
from repro_torch.models import build  # noqa: E402
from repro_torch.train.serve_step import make_prefill  # noqa: E402

# The ops of the MoE dispatch (models/moe.py: route and the scatter and
# gather of moe_apply); elementwise work they share with the rest of the
# model (where, copies, fills) counts as "other".
DISPATCH = {"aten::sort", "aten::argsort", "aten::searchsorted",
            "aten::index", "aten::index_put_", "aten::_index_put_impl_",
            "aten::index_add_", "aten::nonzero", "aten::bincount",
            "aten::repeat_interleave"}
GROUPS = {"aten::bmm": "expert products (bmm)",
          "aten::mm": "weight products (mm)"}


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    seq, served_cut, _ = PREFILL[QWEN3]
    cfg = get_config(QWEN3).replace(use_flash_kernel=True, **served_cut)
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

    fa_kernel.launches = 0
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        prefill(tokens)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    if fa_kernel.launches != cfg.n_layers:
        raise AssertionError(f"flash launches {fa_kernel.launches}, want "
                             f"{cfg.n_layers}")
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    if busy_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    ops = [e for e in events if e.device_type == DeviceType.CPU
           and e.self_device_time_total > 0]
    print(f"[profile] request wall {wall_ms:.3f} ms (profiled), device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}",
          flush=True)
    grouped = {}
    for e in ops:
        g = GROUPS.get(e.key, "MoE dispatch" if e.key in DISPATCH
                       else "other")
        grouped[g] = grouped.get(g, 0.0) + e.self_device_time_total / 1e3
    flash_ms = sum(e.self_device_time_total for e in kernels
                   if "attn_fwd" in e.key) / 1e3
    grouped["outside aten ops"] = busy_ms - sum(grouped.values())
    for g, t in sorted(grouped.items(), key=lambda kv: -kv[1]):
        print(f"[profile] group {g}: {t:.3f} ms ({t / busy_ms:.4f} of busy)",
              flush=True)
    print(f"[profile] flash-attention kernel: {flash_ms:.3f} ms over "
          f"{cfg.n_layers} launches ({flash_ms / busy_ms:.4f} of busy)",
          flush=True)
    top_ops = sorted(ops, key=lambda e: -e.self_device_time_total)[:20]
    for e in top_ops:
        print(f"[profile] op {e.key}: {e.self_device_time_total / 1e3:.3f} "
              f"ms, {e.count} calls", flush=True)
    top_kernels = sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]
    for e in top_kernels:
        print(f"[profile] kernel {e.key[:90]}: "
              f"{e.self_device_time_total / 1e3:.3f} ms, {e.count} calls",
              flush=True)
    print(json.dumps({
        "arch": QWEN3, "layers": cfg.n_layers, "seq": seq,
        "host_ms_median3": ms, "profiled_wall_ms": wall_ms,
        "device_busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
        "groups_ms": grouped, "flash_ms": flash_ms,
        "top_ops": [{"op": e.key, "ms": e.self_device_time_total / 1e3,
                     "calls": e.count} for e in top_ops],
        "top_kernels": [{"kernel": e.key, "ms": e.self_device_time_total
                         / 1e3, "calls": e.count} for e in top_kernels],
        "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
