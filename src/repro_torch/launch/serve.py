"""Serving driver: batched prefill + greedy decode, on the CUDA card unless
``--device cpu`` is given.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch h2o-danube-1.8b \
        --no-smoke --batch 4 --prompt-len 256 --max-new 32
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Tuple

import torch

from ..configs import get_config, memory_len
from ..device import DeviceLike, generator, maybe_synchronize, \
    resolve_device
from ..models import LanguageModel, build
from ..train.serve_step import greedy_generate


def setup(arch: str, *, smoke: bool, batch: int, prompt_len: int, seed: int,
          device: DeviceLike = None
          ) -> Tuple[LanguageModel, torch.Tensor, Optional[torch.Tensor]]:
    """The model with random weights from ``seed``, a random prompt and, for
    the audio and vision families, random fp32 memory embeddings (B,
    max(memory_len, 4), d) from ``seed + 1``, all made on ``device`` by
    explicit generators."""
    dev = resolve_device(device)
    cfg = get_config(arch, smoke=smoke)
    model = build(cfg, dev).init(generator(seed, dev))
    gen = generator(seed + 1, dev)
    prompt = torch.randint(0, cfg.vocab, (batch, prompt_len), generator=gen,
                           device=dev)
    memory = None
    mlen = memory_len(cfg, prompt_len)
    if mlen is not None:
        memory = torch.randn((batch, max(mlen, 4), cfg.d_model),
                             generator=gen, device=dev)
    return model, prompt, memory


def serve(arch: str, *, smoke: bool = True, batch: int = 4,
          prompt_len: int = 32, max_new: int = 16, seed: int = 0,
          device: DeviceLike = None):
    model, prompt, memory = setup(arch, smoke=smoke, batch=batch,
                                  prompt_len=prompt_len, seed=seed,
                                  device=device)
    maybe_synchronize(model.device)
    t0 = time.perf_counter()
    out = greedy_generate(model, prompt, max_new=max_new,
                          memory_embeds=memory)
    maybe_synchronize(model.device)
    dt = time.perf_counter() - t0
    toks = batch * max_new
    print(f"[serve] {arch} on {model.device}: generated {toks} tokens in "
          f"{dt:.2f}s ({toks / dt:.1f} tok/s incl. prefill)")
    return out


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: cuda; 'cpu' runs on the "
                         "host)")
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    serve(args.arch, smoke=args.smoke, batch=args.batch,
          prompt_len=args.prompt_len, max_new=args.max_new,
          device=args.device)


if __name__ == "__main__":
    main()
