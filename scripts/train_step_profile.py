#!/usr/bin/env python3
"""Where one training step of h2o-danube-1.8b goes on one NVIDIA Hopper
card: the shipped config (bf16, remat "block", attn_chunk 1024) at full
width and depth, batch 8 x seq 2048, as ``chip_smoke.py``'s [train] phase
runs it.

After two warm-up steps of ``train_step.make_train_step``:

- the step's parts on the host clock, each ending in a synchronise (median
  of 3): the whole step, the loss's forward pass, forward + backward, and
  the optimizer (``optim.adamw_update``) on the gradients that backward
  left;
- one whole step under ``torch.profiler`` (CPU and CUDA activities): the
  card's busy time against the step's wall time (the idle share), and the
  top aten ops by self device time with their calls, grouped as the
  weight products (``aten::mm``), attention's batched products
  (``aten::bmm``), softmax forward and backward, and everything else.

    python3 scripts/train_step_profile.py [--batch 8] [--seq 2048]

Prints the card's name and power limit, one line per measurement, and a
JSON object last.  Needs a card (no kernel is built: training runs on the
plain paths).
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.data import SyntheticLMData  # noqa: E402
from repro_torch.device import generator  # noqa: E402
from repro_torch.models import build  # noqa: E402
from repro_torch.optim import adamw_update  # noqa: E402
from repro_torch.train.train_step import (EPS_ROOT, init_state,  # noqa: E402
                                          make_train_step)

ARCH = "h2o-danube-1.8b"
LR = 1e-3
GROUPS = {"aten::mm": "weight products", "aten::bmm": "attention bmm",
          "aten::_softmax": "softmax", "aten::_softmax_backward_data":
          "softmax"}


def host_ms(fn) -> float:
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=2048)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device is visible", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    cfg = get_config(ARCH)
    model = build(cfg, "cuda")
    state = init_state(model, generator(0, "cuda"))
    step = make_train_step(model, lr=LR)
    data = SyntheticLMData(cfg, batch=args.batch, seq_len=args.seq, seed=0)
    batches = [{k: torch.from_numpy(v).cuda() for k, v in
                data.batch_at(i).items()} for i in range(3)]
    for b in batches[:2]:
        step(state, b)
    params = state["params"]

    def forward():
        with torch.no_grad():
            model.loss_fn(batches[2])

    def forward_backward():
        for p in params.values():
            p.grad = None
        model.loss_fn(batches[2])[0].backward()

    def optimizer():
        adamw_update(params, {k: p.grad for k, p in params.items()},
                     state["opt"], lr=LR, eps_root=EPS_ROOT)

    parts = {"step": lambda: step(state, batches[2]), "forward": forward,
             "forward_backward": forward_backward, "optimizer": optimizer}
    ms = {name: statistics.median(host_ms(fn) for _ in range(3))
          for name, fn in parts.items()}
    for p in params.values():
        p.grad = None
    print("[profile] host ms (median of 3): " + " ".join(
        f"{k}={v:.3f}" for k, v in ms.items()), flush=True)

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, batches[2])
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = prof.key_averages()
    busy_ms = sum(e.self_device_time_total for e in events
                  if e.device_type == DeviceType.CUDA) / 1e3
    # aten ops, each with the device time of the kernels it launched
    ops = [e for e in events if e.device_type == DeviceType.CPU
           and e.self_device_time_total > 0]
    print(f"[profile] step wall {wall_ms:.3f} ms (profiled), device busy "
          f"{busy_ms:.3f} ms, idle share {1 - busy_ms / wall_ms:.4f}",
          flush=True)
    grouped = {}
    for e in ops:
        g = GROUPS.get(e.key, "other")
        grouped[g] = grouped.get(g, 0.0) + e.self_device_time_total / 1e3
    if busy_ms <= 0:
        raise AssertionError("the profiler saw no device time")
    for g, t in sorted(grouped.items(), key=lambda kv: -kv[1]):
        print(f"[profile] group {g}: {t:.3f} ms ({t / busy_ms:.4f} of busy)",
              flush=True)
    top = sorted(ops, key=lambda e: -e.self_device_time_total)[:15]
    for e in top:
        print(f"[profile] op {e.key}: {e.self_device_time_total / 1e3:.3f} "
              f"ms, {e.count} calls", flush=True)
    print(json.dumps({
        "arch": ARCH, "batch": args.batch, "seq": args.seq,
        "host_ms": ms, "profiled_wall_ms": wall_ms, "device_busy_ms":
        busy_ms, "groups_ms": grouped,
        "top_ops": [{"op": e.key, "ms": e.self_device_time_total / 1e3,
                     "calls": e.count} for e in top],
        "device": torch.cuda.get_device_name(0)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
