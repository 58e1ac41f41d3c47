"""Training entry point, on the CUDA card unless ``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
        --device cpu                       # the smoke config on the host
    PYTHONPATH=src python -m repro_torch.launch.train --arch h2o-danube-1.8b \
        --full --steps 10 --batch 8 --seq 2048 --lr 1e-3

Counterpart of ``repro/launch/train.py``: deterministic data, WSD/cosine
schedule per arch, gradient clipping, async checkpointing every N steps (in
the reference's format), exact resume, preemption-safe saves.  The model
trains on its plain paths: the kernels are forward-only, as in the
reference, and no shipped config turns them on.
"""
from __future__ import annotations

import argparse
import signal
import time
from typing import Optional

import torch

from ..configs import get_config
from ..data import SyntheticLMData
from ..device import DeviceLike, generator, maybe_synchronize, \
    resolve_device
from ..models import build
from ..models.convert import state_from_jax, state_to_jax
from ..optim.schedule import for_arch
from ..train import checkpoint as ckpt
from ..train.train_step import init_state, make_train_step


def train(arch: str, *, smoke: bool = True, steps: int = 50,
          batch: int = 8, seq: int = 128, lr: float = 3e-4,
          microbatches: int = 1, compress_grads: bool = False,
          ckpt_dir: Optional[str] = None, ckpt_every: int = 25,
          log_every: int = 10, seed: int = 0,
          resume: bool = True, device: DeviceLike = None) -> dict:
    """Train ``arch`` for ``steps`` steps (from the latest checkpoint under
    ``ckpt_dir`` when ``resume``).  Returns the reference's dict
    (``losses``, ``final_loss``, ``state``) plus ``history``: one dict a
    step run here with its ``loss``, ``grad_norm``, ``lr`` and ``ms`` (host
    clock around the step, ending in a device synchronise)."""
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    model = build(cfg, dev)
    data = SyntheticLMData(cfg, batch=batch, seq_len=seq, seed=seed)
    schedule = for_arch(arch, lr, max(steps // 20, 5), steps)
    step_fn = make_train_step(model, lr=schedule, microbatches=microbatches,
                              compress_grads=compress_grads)

    start_step = 0
    state = init_state(model, generator(seed, dev),
                       compress_grads=compress_grads)
    if ckpt_dir and resume:
        latest = ckpt.latest_step_dir(ckpt_dir)
        if latest:
            tree, manifest = ckpt.restore(latest, state_to_jax(state))
            state_from_jax(tree, state)
            start_step = manifest["step"]
            print(f"[train] resumed from {latest} at step {start_step}")

    saver = ckpt.AsyncCheckpointer()
    interrupted = {"flag": False}

    def _on_signal(signum, frame):     # preemption-safe emergency save
        interrupted["flag"] = True
    old = signal.signal(signal.SIGTERM, _on_signal)

    losses, history = [], []
    t0 = time.time()
    try:
        for step in range(start_step, steps):
            maybe_synchronize(dev)
            t_step = time.perf_counter()
            b = {k: torch.from_numpy(v).to(dev)
                 for k, v in data.batch_at(step).items()}
            state, metrics = step_fn(state, b)
            maybe_synchronize(dev)
            ms = (time.perf_counter() - t_step) * 1e3
            losses.append(float(metrics["loss"]))
            history.append({"loss": losses[-1],
                            "grad_norm": float(metrics["grad_norm"]),
                            "lr": float(metrics["lr"]), "ms": ms})
            if log_every and (step + 1) % log_every == 0:
                rate = (step + 1 - start_step) / (time.time() - t0)
                print(f"[train] step {step + 1}/{steps} "
                      f"loss {losses[-1]:.4f} "
                      f"lr {history[-1]['lr']:.2e} "
                      f"gnorm {history[-1]['grad_norm']:.2f} "
                      f"({rate:.2f} it/s)")
            if ckpt_dir and ((step + 1) % ckpt_every == 0
                             or interrupted["flag"]):
                saver.save(f"{ckpt_dir}/ckpt_{step + 1:06d}",
                           state_to_jax(state), step=step + 1)
            if interrupted["flag"]:
                print("[train] SIGTERM: emergency checkpoint written")
                break
    finally:
        saver.wait()
        signal.signal(signal.SIGTERM, old)
    if ckpt_dir:
        saver.save(f"{ckpt_dir}/ckpt_{steps:06d}", state_to_jax(state),
                   step=steps)
        saver.wait()
    return {"losses": losses, "final_loss": losses[-1] if losses else None,
            "state": state, "history": history}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", default=True)
    ap.add_argument("--full", dest="smoke", action="store_false")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the "
                         "host)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    out = train(args.arch, smoke=args.smoke, steps=args.steps,
                batch=args.batch, seq=args.seq, lr=args.lr,
                microbatches=args.microbatches,
                compress_grads=args.compress_grads,
                ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                device=args.device)
    print(f"[train] done; final loss {out['final_loss']:.4f}")


if __name__ == "__main__":
    main()
