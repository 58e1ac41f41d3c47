"""Synthetic data pipeline.

Deterministic, seekable token stream (Zipf-ish unigram + short-range
structure so tiny models can actually learn), with:
  * per-step deterministic batches (resume = skip to step, no state files),
  * host prefetch thread (double-buffering),
  * stub modality frontends (frame/patch embeddings) for audio/vlm archs.

Counterpart of ``repro/data/pipeline.py``: pure numpy, so a batch here
equals the reference's bit for bit.  Batches stay numpy; the caller moves
them to its device.  ``make_batch_specs`` gives the inputs' shapes and
dtypes as meta-device tensors, the reference's ``ShapeDtypeStruct``s.
"""
from __future__ import annotations

import queue
import threading
from typing import Dict, Iterator

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..configs.registry import memory_len


class SyntheticLMData:
    """Deterministic synthetic LM batches: batch(step) is a pure function
    of (seed, step), which makes checkpoint-resume trivial and exact."""

    def __init__(self, cfg: ModelConfig, *, batch: int, seq_len: int,
                 seed: int = 0):
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed
        # Zipf-ish unigram over a capped alphabet (keeps tiny models
        # learnable); structure: next token correlates with current.
        self.alphabet = min(cfg.vocab, 4096)
        ranks = np.arange(1, self.alphabet + 1, dtype=np.float64)
        self.unigram = (1.0 / ranks) / np.sum(1.0 / ranks)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(
            np.random.SeedSequence([self.seed, step]))
        b, s = self.batch, self.seq_len
        toks = rng.choice(self.alphabet, size=(b, s + 1), p=self.unigram)
        # short-range structure: with p=0.5, t+1 = (t + 1) mod alphabet
        copy_mask = rng.random((b, s)) < 0.5
        nxt = (toks[:, :-1] + 1) % self.alphabet
        toks[:, 1:] = np.where(copy_mask, nxt, toks[:, 1:])
        out = {"tokens": toks[:, :-1].astype(np.int32),
               "labels": toks[:, 1:].astype(np.int32)}
        mlen = memory_len(self.cfg, s)
        if mlen is not None:
            out["memory_embeds"] = rng.standard_normal(
                (b, mlen, self.cfg.d_model)).astype(np.float32)
        return out

    def iter_batches(self, start_step: int = 0,
                     prefetch: int = 2) -> Iterator[Dict[str, np.ndarray]]:
        """Prefetching iterator (host thread double-buffers)."""
        q: queue.Queue = queue.Queue(maxsize=prefetch)
        stop = threading.Event()

        def worker():
            step = start_step
            while not stop.is_set():
                q.put(self.batch_at(step))
                step += 1

        t = threading.Thread(target=worker, daemon=True)
        t.start()
        try:
            while True:
                yield q.get()
        finally:
            stop.set()


def make_batch_specs(cfg: ModelConfig, *, batch: int, seq_len: int,
                     dtype=torch.int32) -> Dict[str, torch.Tensor]:
    """Meta-device stand-ins (shape and dtype, no memory) for every model
    input (dry-run use)."""
    specs = {
        "tokens": torch.empty((batch, seq_len), dtype=dtype, device="meta"),
        "labels": torch.empty((batch, seq_len), dtype=dtype, device="meta"),
    }
    mlen = memory_len(cfg, seq_len)
    if mlen is not None:
        specs["memory_embeds"] = torch.empty(
            (batch, mlen, cfg.d_model), dtype=getattr(torch, cfg.dtype),
            device="meta")
    return specs
