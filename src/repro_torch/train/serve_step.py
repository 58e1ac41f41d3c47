"""Serving: prefill + batched one-token decode steps, plus a simple batched
greedy request loop.  Counterpart of ``repro/train/serve_step.py``.

PyTorch runs eagerly, so nothing is jitted; every call runs under
``torch.inference_mode()``.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..models import LanguageModel
from ..obs.compute import compute_span


def make_prefill(model: LanguageModel) -> Callable:
    """prefill(tokens[, memory_embeds]) -> last-token logits (B, V).

    Runs the full ``forward``, which is where the kernels run when
    ``use_flash_kernel`` is set: flash attention in the self-attention of
    the attention and cross-attention blocks and in the encoder, at any
    length (at S % 128 == 0 only, for a model with an attention softcap),
    the SSD scan in the ssm blocks.  The sequential
    ``model.prefill`` of ``greedy_generate`` fills a cache instead.

    Each call is the root compute span ``prefill`` (attr ``tokens``, B·S)
    while a profiler trace is being taken."""

    @torch.inference_mode()
    def prefill(tokens, memory_embeds=None):
        with compute_span("prefill", "tokens", tokens.numel(),
                          device=tokens.device):
            logits, _ = model.forward(tokens, memory_embeds=memory_embeds)
            return logits[:, -1, :]

    return prefill


def make_serve_step(model: LanguageModel) -> Callable:
    """serve_step(cache, tokens (B,1), pos[, memory_embeds]) -> (logits,
    cache).  One new token against a KV cache, updated in place."""

    @torch.inference_mode()
    def serve_step(cache, tokens, pos, memory_embeds=None):
        return model.decode_step(cache, tokens, pos,
                                 memory_embeds=memory_embeds)

    return serve_step


@torch.inference_mode()
def greedy_generate(model: LanguageModel, prompt, *, max_new: int,
                    memory_embeds=None):
    """Batched greedy decoding: (B, S) prompt -> (B, max_new) int32 tokens;
    ``memory_embeds`` (B, M, d) for the audio and vision families."""
    b, s = prompt.shape
    cache = model.init_cache(b, s + max_new)
    # prefill fills the cache through position s-1 and returns the
    # last-token logits
    logits, cache = model.prefill(prompt, cache,
                                  memory_embeds=memory_embeds)

    toks = []
    for i in range(max_new):
        nxt = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        toks.append(nxt)
        if i + 1 < max_new:
            logits, cache = model.decode_step(cache, nxt, s + i,
                                              memory_embeds=memory_embeds)
    return torch.cat(toks, dim=1)
