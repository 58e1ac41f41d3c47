"""Attention: GQA (full / sliding-window / chunked, causal or
bidirectional), prefill through the flash-attention kernel, cross-attention
against a memory, and one-token decode against a KV cache.

Counterpart of ``repro/models/attention.py``, with its ``constrain``
sharding hints (no-ops on a plain tensor).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn
from torch.distributed.tensor import DTensor

from ..configs.base import ModelConfig
from ..distributed.sharding import constrain, logical_rank, per_shard, \
    set_slot, whole_units
from .layers import apply_rope, dense_init, dtype_of, empty_param, \
    pdtype_of, softcap

NEG_INF = -1e30
_HEADS = ("batch", "seq", "heads", None)


class Attention(nn.Module):
    """Parameters ``wq`` (d, Hq*hd), ``wk``/``wv`` (d, Hkv*hd) and ``wo``
    (Hq*hd, d), as in the reference's ``attn_init``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        hd = cfg.head_dim
        self.wq = empty_param((cfg.d_model, cfg.n_heads * hd), cfg, device)
        self.wk = empty_param((cfg.d_model, cfg.n_kv_heads * hd), cfg, device)
        self.wv = empty_param((cfg.d_model, cfg.n_kv_heads * hd), cfg, device)
        self.wo = empty_param((cfg.n_heads * hd, cfg.d_model), cfg, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator, cfg: ModelConfig):
        pd = pdtype_of(cfg)
        for w in (self.wq, self.wk, self.wv):
            w.copy_(dense_init(generator, *w.shape, pd))
        self.wo.copy_(dense_init(generator, *self.wo.shape, pd,
                                 scale=cfg.residual_scale))


def _split_heads(x, n_heads, hd):
    b, s, _ = x.shape
    return whole_units(x, 2, n_heads).reshape(b, s, n_heads, hd)


def _mask(sq: int, skv: int, *, causal: bool, window: int,
          q_offset: int = 0, device=None):
    """Mask of queries ``q_offset ..`` against keys ``0 .. skv-1``: causal
    when ``causal``, narrowed to keys no more than ``window`` behind the
    query when ``window > 0``."""
    q_ids = q_offset + torch.arange(sq, device=device)[:, None]
    k_ids = torch.arange(skv, device=device)[None, :]
    m = torch.ones((sq, skv), dtype=torch.bool, device=device)
    if causal:
        m &= k_ids <= q_ids
    if window > 0:
        m &= k_ids >= q_ids - window
    return m


def _sdpa(q, k, v, *, scale: float, causal: bool, window: int,
          logit_cap: float, q_offset: int = 0):
    """q: (B,Sq,H,hd); k,v: (B,Skv,Hkv,hd) -> (B,Sq,H,hd)."""
    b, sq, h, hd = q.shape
    hkv = k.shape[2]
    group = h // hkv
    qg = q.reshape(b, sq, hkv, group, hd)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    s = softcap(s, logit_cap)
    mask = _mask(sq, k.shape[1], causal=causal, window=window,
                 q_offset=q_offset, device=q.device)
    s = torch.where(mask[None, None, None], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(b, sq, h, hd).to(q.dtype)


def _sdpa_chunked(q, k, v, *, scale: float, causal: bool, window: int,
                  logit_cap: float, chunk: int):
    """Loop over query chunks; never materialises (Sq, Skv) for all queries
    at once.  Memory per step: (B,H,chunk,Skv).  The Python loop replaces
    the reference's ``lax.scan`` (and its ``unroll`` switch, which only
    served XLA's cost accounting)."""
    b, sq, h, hd = q.shape
    assert sq % chunk == 0, (sq, chunk)
    outs = [_sdpa(q[:, i:i + chunk], k, v, scale=scale, causal=causal,
                  window=window, logit_cap=logit_cap, q_offset=i)
            for i in range(0, sq, chunk)]
    return torch.cat(outs, dim=1)


def flash_takes_length(cfg: ModelConfig, s: int) -> bool:
    """Whether the flash kernel computes ``cfg``'s self-attention over ``s``
    positions.  The kernel masks keys past S and stores only rows below it,
    so it takes any length.  It has no softcap: a softcapped model keeps the
    plain path off the reference's 128 grid, and on the grid drops the
    softcap, as the reference does."""
    return s % 128 == 0 or cfg.attn_logit_softcap == 0


def attn_apply(p: Attention, x, cfg: ModelConfig, *, causal: bool = True,
               window: int = 0, kv_override: Optional[torch.Tensor] = None):
    """Prefill attention, with the reference's dispatch order: flash kernel,
    else chunked, else plain.  ``kv_override`` (B, M, d): a memory that K and
    V are projected from (cross-attention); then no rotary embedding is
    applied and the kernel is not used, as in the reference.  Unlike the
    reference, whose kernel takes only S % 128 == 0, the kernel takes every
    length of a model without an attention softcap."""
    dt = dtype_of(cfg)
    b, s, _ = x.shape
    hd = cfg.head_dim
    src = x if kv_override is None else kv_override
    q = _split_heads(x @ p.wq.to(dt), cfg.n_heads, hd)
    k = _split_heads(src @ p.wk.to(dt), cfg.n_kv_heads, hd)
    v = _split_heads(src @ p.wv.to(dt), cfg.n_kv_heads, hd)
    if kv_override is None:
        positions = torch.arange(s, device=x.device)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
    if isinstance(k, DTensor) and \
            cfg.n_kv_heads % logical_rank("heads")[1]:
        # the KV heads do not split over the ranks the query heads split
        # over: each, summed whole first, is repeated for its group of
        # query heads
        g = cfg.n_heads // cfg.n_kv_heads
        k, v = (constrain(t, ("batch", "seq", None, None))[:, :, :, None]
                .expand(b, t.shape[1], cfg.n_kv_heads, g, hd)
                .reshape(b, t.shape[1], cfg.n_heads, hd) for t in (k, v))
    q = constrain(q, _HEADS)
    k = constrain(k, _HEADS)
    scale = hd ** -0.5

    def core(q, k, v):
        if cfg.use_flash_kernel and kv_override is None and \
                flash_takes_length(cfg, s):
            from ..kernels.flash_attention import flash_attention
            # (B,S,H,D) -> (B,H,S,D) views; the kernel reads them through
            # their strides.
            o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), sm_scale=scale,
                                causal=causal, window=window)
            return o.transpose(1, 2)
        if cfg.attn_chunk > 0 and s > cfg.attn_chunk \
                and s % cfg.attn_chunk == 0:
            return _sdpa_chunked(q, k, v, scale=scale, causal=causal,
                                 window=window,
                                 logit_cap=cfg.attn_logit_softcap,
                                 chunk=cfg.attn_chunk)
        return _sdpa(q, k, v, scale=scale, causal=causal, window=window,
                     logit_cap=cfg.attn_logit_softcap)
    # per (batch row, head): local on each rank under a mesh
    o = per_shard(core, (q, k, v), (_HEADS,) * 3, _HEADS, q.shape)
    o = whole_units(constrain(o, _HEADS), 2, cfg.n_heads)
    out = o.reshape(b, s, cfg.n_heads * hd) @ p.wo.to(dt)
    return constrain(out, ("batch", "seq", "embed"))


# ---------------------------------------------------------------------------
# KV cache + decode
# ---------------------------------------------------------------------------

def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int, *,
                  window: int = 0, device=None) -> Dict:
    """Linear cache for full attention; ring cache of size `window + 1` for
    SWA (the mask k >= q - window keeps window+1 keys including the current
    token)."""
    size = min(window + 1, max_len) if window > 0 else max_len
    shape = (batch, size, cfg.n_kv_heads, cfg.head_dim)
    dt = dtype_of(cfg)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}


def decode_attn_apply(p: Attention, x, cache: Dict, pos: int,
                      cfg: ModelConfig, *, window: int = 0):
    """One-token decode.  x: (B, 1, D); pos: int (same for the whole batch);
    returns (out, cache).  The cache is updated IN PLACE (the reference
    returns a new one) and returned for the same call shape."""
    dt = dtype_of(cfg)
    b = x.shape[0]
    hd = cfg.head_dim
    q = _split_heads(x @ p.wq.to(dt), cfg.n_heads, hd)
    k_new = _split_heads(x @ p.wk.to(dt), cfg.n_kv_heads, hd)
    v_new = _split_heads(x @ p.wv.to(dt), cfg.n_kv_heads, hd)
    posv = torch.full((b, 1), pos, device=x.device)
    q = apply_rope(q, posv, cfg.rope_theta)
    k_new = apply_rope(k_new, posv, cfg.rope_theta)

    size = cache["k"].shape[1]
    slot = pos % size if window > 0 else pos
    set_slot(cache["k"], 1, slot, k_new[:, 0])          # in place
    set_slot(cache["v"], 1, slot, v_new[:, 0])          # in place
    k, v = cache["k"], cache["v"]

    hkv = cfg.n_kv_heads
    group = cfg.n_heads // hkv
    qg = q.reshape(b, hkv, group, hd)
    s = torch.einsum("bkgd,bskd->bkgs", qg.float(), k.float()) * hd ** -0.5
    s = softcap(s, cfg.attn_logit_softcap)

    slots = torch.arange(size, device=x.device)
    if window > 0:
        # ring buffer: slot holds absolute position pos - age, with age the
        # slot's distance behind the newest one; valid once written
        age = (slot - slots) % size
        valid = pos - age >= 0
    else:
        valid = slots <= pos
    s = torch.where(valid[None, None, None, :], s, NEG_INF)
    pbar = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", pbar, v.float())
    o = o.reshape(b, 1, cfg.n_heads * hd).to(dt)
    # the partial sums of a head-split product are summed here, as the
    # reference's partitioner sums them
    return constrain(o @ p.wo.to(dt), ("batch", "seq", "embed")), cache
