"""Multi-head Latent Attention (DeepSeek-V3): KV compressed into a small
latent; the cache stores (latent, shared rope key) instead of full K/V.

Counterpart of ``repro/models/mla.py``.  As there, the scores are
materialised whole in fp32 (no chunking, no kernel).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..device import DeviceLike, resolve_device
from ..distributed.sharding import constrain, per_shard, set_slot
from .attention import NEG_INF
from .layers import apply_rope, dense_init, dtype_of, empty_param, pdtype_of


class MLA(nn.Module):
    """Parameters with the reference's leaf names (``mla_init``): ``w_dkv``
    (d, kv_lora + rope_dim), ``w_uk`` and ``w_uv`` (kv_lora, H*hd), ``wo``
    (H*hd, d), and the queries through ``w_qa`` (d, q_lora) and ``w_qb``
    (q_lora, H*(hd + rope_dim)) when ``q_lora_rank > 0``, else ``wq`` (d,
    H*(hd + rope_dim))."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d, h = cfg.d_model, cfg.n_heads
        hd, rd, kv = cfg.head_dim, cfg.rope_head_dim, cfg.kv_lora_rank
        self.w_dkv = empty_param((d, kv + rd), cfg, device)
        self.w_uk = empty_param((kv, h * hd), cfg, device)
        self.w_uv = empty_param((kv, h * hd), cfg, device)
        self.wo = empty_param((h * hd, d), cfg, device)
        self.q_lora = cfg.q_lora_rank > 0
        if self.q_lora:
            self.w_qa = empty_param((d, cfg.q_lora_rank), cfg, device)
            self.w_qb = empty_param((cfg.q_lora_rank, h * (hd + rd)), cfg,
                                    device)
        else:
            self.wq = empty_param((d, h * (hd + rd)), cfg, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator, cfg: ModelConfig):
        pd = pdtype_of(cfg)
        qs = (self.w_qa, self.w_qb) if self.q_lora else (self.wq,)
        for w in (self.w_dkv, self.w_uk, self.w_uv) + qs:
            w.copy_(dense_init(generator, *w.shape, pd))
        self.wo.copy_(dense_init(generator, *self.wo.shape, pd,
                                 scale=cfg.residual_scale))


def _queries(p: MLA, x, cfg: ModelConfig, positions):
    dt = dtype_of(cfg)
    b, s, _ = x.shape
    hd, rd = cfg.head_dim, cfg.rope_head_dim
    if p.q_lora:
        q = (x @ p.w_qa.to(dt)) @ p.w_qb.to(dt)
    else:
        q = x @ p.wq.to(dt)
    q = q.reshape(b, s, cfg.n_heads, hd + rd)
    q_nope, q_rope = q[..., :hd], q[..., hd:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return q_nope, q_rope


def _latent_kv(p: MLA, x, cfg: ModelConfig, positions):
    """(latent (B, S, kv_lora), k_rope (B, S, rope_dim)): one rope key
    shared by every head."""
    ckv = x @ p.w_dkv.to(dtype_of(cfg))
    latent, k_rope = ckv[..., :cfg.kv_lora_rank], ckv[..., cfg.kv_lora_rank:]
    k_rope = apply_rope(k_rope[:, :, None, :], positions,
                        cfg.rope_theta)[:, :, 0, :]
    return latent, k_rope


def _attend(q_nope, q_rope, latent, k_rope, p: MLA, cfg: ModelConfig, *,
            causal: bool, valid=None):
    dt = dtype_of(cfg)
    b, sq = q_nope.shape[:2]
    skv = latent.shape[1]
    hd = cfg.head_dim
    k = (latent @ p.w_uk.to(dt)).reshape(b, skv, cfg.n_heads, hd)
    v = (latent @ p.w_uv.to(dt)).reshape(b, skv, cfg.n_heads, hd)
    scale = (hd + cfg.rope_head_dim) ** -0.5

    def core(q_nope, q_rope, k, v, k_rope):
        s = (torch.einsum("bqhd,bshd->bhqs", q_nope.float(), k.float())
             + torch.einsum("bqhr,bsr->bhqs", q_rope.float(),
                            k_rope.float())) * scale
        if causal:
            q_ids = torch.arange(sq, device=s.device)[:, None]
            k_ids = torch.arange(skv, device=s.device)[None, :]
            s = torch.where((k_ids <= q_ids)[None, None], s, NEG_INF)
        if valid is not None:
            s = torch.where(valid[None, None, None, :], s, NEG_INF)
        pbar = torch.softmax(s, dim=-1)
        return torch.einsum("bhqs,bshd->bqhd", pbar, v.float())
    # per (batch row, head): local on each rank under a mesh
    heads = ("batch", "seq", "heads", None)
    o = per_shard(core, (q_nope, q_rope, k, v, k_rope),
                  (heads, heads, heads, heads, ("batch", "seq", None)),
                  heads, (b, sq, cfg.n_heads, hd))
    return o.reshape(b, sq, cfg.n_heads * hd).to(dt)


def mla_apply(p: MLA, x, cfg: ModelConfig):
    """Causal prefill: x (B, S, d) -> (B, S, d)."""
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    q_nope, q_rope = _queries(p, x, cfg, positions)
    latent, k_rope = _latent_kv(p, x, cfg, positions)
    latent = constrain(latent, ("batch", "seq", None))
    o = _attend(q_nope, q_rope, latent, k_rope, p, cfg, causal=True)
    return constrain(o @ p.wo.to(dtype_of(cfg)), ("batch", "seq", "embed"))


def init_mla_cache(cfg: ModelConfig, batch: int, max_len: int,
                   device: DeviceLike = None) -> Dict:
    """{"latent": (B, max_len, kv_lora), "k_rope": (B, max_len, rope_dim)}
    in the compute dtype, zeros, on ``device`` (default: the card)."""
    dt = dtype_of(cfg)
    dev = resolve_device(device)
    return {
        "latent": torch.zeros((batch, max_len, cfg.kv_lora_rank), dtype=dt,
                              device=dev),
        "k_rope": torch.zeros((batch, max_len, cfg.rope_head_dim), dtype=dt,
                              device=dev),
    }


def mla_decode(p: MLA, x, cache: Dict, pos: int, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Dict]:
    """One token: x (B, 1, d) -> (out (B, 1, d), cache).  Both cache
    tensors are updated IN PLACE at ``pos`` (the reference returns new
    ones) and the cache is returned."""
    b = x.shape[0]
    posv = torch.full((b, 1), pos, device=x.device)
    q_nope, q_rope = _queries(p, x, cfg, posv)
    lat_new, kr_new = _latent_kv(p, x, cfg, posv)
    set_slot(cache["latent"], 1, pos, lat_new[:, 0])
    set_slot(cache["k_rope"], 1, pos, kr_new[:, 0])
    latent, k_rope = cache["latent"], cache["k_rope"]
    valid = torch.arange(latent.shape[1], device=x.device) <= pos
    o = _attend(q_nope, q_rope, latent, k_rope, p, cfg, causal=False,
                valid=valid)
    out = o @ p.wo.to(dtype_of(cfg))
    return constrain(out, ("batch", "seq", "embed")), cache
