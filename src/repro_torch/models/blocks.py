"""Block registry: per-kind block modules with ``init``, ``forward``,
``init_cache`` and ``decode``.  Counterpart of ``repro/models/blocks.py``.

Every block owns its norms and residual adds, and its ``forward`` returns
``(x, aux)``: the MoE block's load-balancing loss, a zero for the other
kinds, as in the reference.  ``forward`` and ``decode`` take a ``memory``
keyword (B, M, d), which only the cross-attention block reads.  Kinds:
  attn        full causal GQA attention + SwiGLU MLP
  local_attn  sliding-window GQA attention + MLP
  moe         (MLA or GQA) attention + MoE FFN
  ssm         Mamba2 mixer (SSD scan), no MLP
  rglru       RG-LRU recurrent mixer + MLP
  cross_attn  self-attn + cross-attn(memory) + MLP (whisper dec / vlm)
  enc_attn    bidirectional attention + MLP (whisper encoder), no decode

``AttnBlock`` and ``SsmBlock`` open the compute spans ``norm``,
``attention``, ``mlp`` and ``ssm`` around their sub-layers
(``obs.compute``); the residual adds stay in the enclosing span.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..obs.compute import compute_span
from . import attention as attn_mod
from . import mla as mla_mod
from . import moe as moe_mod
from . import rglru as rglru_mod
from . import ssm as ssm_mod
from .layers import MLP, empty_param, mlp_apply, rmsnorm


def _zero(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


class AttnBlock(nn.Module):
    """``attn`` (window 0), ``local_attn`` (window = cfg.window) and
    ``enc_attn`` (bidirectional, no decode) blocks: parameters ``ln1``,
    ``attn`` and, when d_ff > 0, ``ln2`` and ``mlp``."""

    def __init__(self, cfg: ModelConfig, device, *, window: int = 0,
                 causal: bool = True):
        super().__init__()
        self.window = window
        self.causal = causal
        self.ln1 = empty_param((cfg.d_model,), cfg, device)
        self.attn = attn_mod.Attention(cfg, device)
        self.has_mlp = cfg.d_ff > 0
        if self.has_mlp:
            self.ln2 = empty_param((cfg.d_model,), cfg, device)
            self.mlp = MLP(cfg, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator, cfg: ModelConfig):
        self.ln1.fill_(1.0)
        self.attn.init(generator, cfg)
        if self.has_mlp:
            self.ln2.fill_(1.0)
            self.mlp.init(generator, cfg)

    def forward(self, x, cfg: ModelConfig, memory=None):
        with compute_span("norm"):
            h = rmsnorm(x, self.ln1, cfg.norm_eps)
        with compute_span("attention"):
            o = attn_mod.attn_apply(self.attn, h, cfg, causal=self.causal,
                                    window=self.window)
        x = x + o
        if self.has_mlp:
            with compute_span("norm"):
                h = rmsnorm(x, self.ln2, cfg.norm_eps)
            with compute_span("mlp"):
                o = mlp_apply(self.mlp, h, cfg)
            x = x + o
        return x, _zero(x)

    def init_cache(self, cfg: ModelConfig, batch: int, max_len: int,
                   device) -> Dict:
        return {"kv": attn_mod.init_kv_cache(cfg, batch, max_len,
                                             window=self.window,
                                             device=device)}

    def decode(self, x, cache: Dict, pos: int, cfg: ModelConfig,
               memory=None):
        """One token; updates ``cache`` in place and returns it."""
        if not self.causal:
            raise TypeError("a bidirectional (enc_attn) block has no "
                            "one-token decode")
        h = rmsnorm(x, self.ln1, cfg.norm_eps)
        o, cache["kv"] = attn_mod.decode_attn_apply(
            self.attn, h, cache["kv"], pos, cfg, window=self.window)
        x = x + o
        if self.has_mlp:
            h = rmsnorm(x, self.ln2, cfg.norm_eps)
            x = x + mlp_apply(self.mlp, h, cfg)
        return x, cache


class MoeBlock(nn.Module):
    """``moe`` block: parameters ``ln1``, ``attn`` (MLA when
    ``cfg.use_mla``, else GQA), ``ln2`` and ``moe``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.use_mla = cfg.use_mla
        self.ln1 = empty_param((cfg.d_model,), cfg, device)
        self.attn = (mla_mod.MLA(cfg, device) if cfg.use_mla
                     else attn_mod.Attention(cfg, device))
        self.ln2 = empty_param((cfg.d_model,), cfg, device)
        self.moe = moe_mod.MoE(cfg, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator, cfg: ModelConfig):
        self.ln1.fill_(1.0)
        self.attn.init(generator, cfg)
        self.ln2.fill_(1.0)
        self.moe.init(generator, cfg)

    def forward(self, x, cfg: ModelConfig, memory=None):
        h = rmsnorm(x, self.ln1, cfg.norm_eps)
        if self.use_mla:
            x = x + mla_mod.mla_apply(self.attn, h, cfg)
        else:
            x = x + attn_mod.attn_apply(self.attn, h, cfg)
        h = rmsnorm(x, self.ln2, cfg.norm_eps)
        y, aux = moe_mod.moe_apply(self.moe, h, cfg)
        return x + y, aux

    def init_cache(self, cfg: ModelConfig, batch: int, max_len: int,
                   device) -> Dict:
        if self.use_mla:
            return {"mla": mla_mod.init_mla_cache(cfg, batch, max_len,
                                                  device=device)}
        return {"kv": attn_mod.init_kv_cache(cfg, batch, max_len,
                                             device=device)}

    def decode(self, x, cache: Dict, pos: int, cfg: ModelConfig,
               memory=None):
        """One token; updates ``cache`` in place and returns it."""
        h = rmsnorm(x, self.ln1, cfg.norm_eps)
        if self.use_mla:
            o, cache["mla"] = mla_mod.mla_decode(self.attn, h, cache["mla"],
                                                 pos, cfg)
        else:
            o, cache["kv"] = attn_mod.decode_attn_apply(
                self.attn, h, cache["kv"], pos, cfg)
        x = x + o
        h = rmsnorm(x, self.ln2, cfg.norm_eps)
        y, _ = moe_mod.moe_apply(self.moe, h, cfg)
        return x + y, cache


class SsmBlock(nn.Module):
    """``ssm`` block: parameters ``ln1`` and ``ssm`` (the Mamba2 mixer); no
    MLP, as in the reference."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = empty_param((cfg.d_model,), cfg, device)
        self.ssm = ssm_mod.SSM(cfg, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator, cfg: ModelConfig):
        self.ln1.fill_(1.0)
        self.ssm.init(generator, cfg)

    def forward(self, x, cfg: ModelConfig, memory=None):
        with compute_span("norm"):
            h = rmsnorm(x, self.ln1, cfg.norm_eps)
        with compute_span("ssm"):
            o = ssm_mod.ssm_apply(self.ssm, h, cfg)
        return x + o, _zero(x)

    def init_cache(self, cfg: ModelConfig, batch: int, max_len: int,
                   device) -> Dict:
        return {"ssm": ssm_mod.init_ssm_cache(cfg, batch, device)}

    def decode(self, x, cache: Dict, pos: int, cfg: ModelConfig,
               memory=None):
        """One token; updates ``cache`` in place and returns it."""
        h = rmsnorm(x, self.ln1, cfg.norm_eps)
        o, cache["ssm"] = ssm_mod.ssm_decode(self.ssm, h, cache["ssm"], pos,
                                             cfg)
        return x + o, cache


class RglruBlock(nn.Module):
    """``rglru`` block: parameters ``ln1``, ``lru`` (the RG-LRU mixer) and,
    when d_ff > 0, ``ln2`` and ``mlp``."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        self.ln1 = empty_param((cfg.d_model,), cfg, device)
        self.lru = rglru_mod.RGLRU(cfg, device)
        self.has_mlp = cfg.d_ff > 0
        if self.has_mlp:
            self.ln2 = empty_param((cfg.d_model,), cfg, device)
            self.mlp = MLP(cfg, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator, cfg: ModelConfig):
        self.ln1.fill_(1.0)
        self.lru.init(generator, cfg)
        if self.has_mlp:
            self.ln2.fill_(1.0)
            self.mlp.init(generator, cfg)

    def _mlp(self, x, cfg: ModelConfig):
        if self.has_mlp:
            x = x + mlp_apply(self.mlp, rmsnorm(x, self.ln2, cfg.norm_eps),
                              cfg)
        return x

    def forward(self, x, cfg: ModelConfig, memory=None):
        h = rmsnorm(x, self.ln1, cfg.norm_eps)
        x = x + rglru_mod.rglru_apply(self.lru, h, cfg)
        return self._mlp(x, cfg), _zero(x)

    def init_cache(self, cfg: ModelConfig, batch: int, max_len: int,
                   device) -> Dict:
        return {"lru": rglru_mod.init_rglru_cache(cfg, batch, device)}

    def decode(self, x, cache: Dict, pos: int, cfg: ModelConfig,
               memory=None):
        """One token; updates ``cache`` in place and returns it."""
        h = rmsnorm(x, self.ln1, cfg.norm_eps)
        o, cache["lru"] = rglru_mod.rglru_decode(self.lru, h, cache["lru"],
                                                 pos, cfg)
        return self._mlp(x + o, cfg), cache


class CrossAttnBlock(nn.Module):
    """``cross_attn`` block: causal self-attention (``ln1``, ``attn``), then
    attention from the stream to a memory (``lnx``, ``xattn``) scaled by
    tanh of the 0-d gate ``xgate`` (zero at init, as in the reference: a
    fresh block adds nothing from the memory), then the MLP (``ln2``,
    ``mlp``)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        d = cfg.d_model
        self.ln1 = empty_param((d,), cfg, device)
        self.attn = attn_mod.Attention(cfg, device)
        self.lnx = empty_param((d,), cfg, device)
        self.xattn = attn_mod.Attention(cfg, device)
        self.ln2 = empty_param((d,), cfg, device)
        self.mlp = MLP(cfg, device)
        self.xgate = empty_param((), cfg, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator, cfg: ModelConfig):
        self.ln1.fill_(1.0)
        self.attn.init(generator, cfg)
        self.lnx.fill_(1.0)
        self.xattn.init(generator, cfg)
        self.ln2.fill_(1.0)
        self.mlp.init(generator, cfg)
        self.xgate.zero_()

    def _cross_and_mlp(self, x, cfg: ModelConfig, memory):
        if memory is None:
            raise ValueError("a cross_attn block needs memory")
        h = rmsnorm(x, self.lnx, cfg.norm_eps)
        xo = attn_mod.attn_apply(self.xattn, h, cfg, causal=False,
                                 kv_override=memory)
        x = x + torch.tanh(self.xgate).to(x.dtype) * xo
        h = rmsnorm(x, self.ln2, cfg.norm_eps)
        return x + mlp_apply(self.mlp, h, cfg)

    def forward(self, x, cfg: ModelConfig, memory=None):
        h = rmsnorm(x, self.ln1, cfg.norm_eps)
        x = x + attn_mod.attn_apply(self.attn, h, cfg)
        return self._cross_and_mlp(x, cfg, memory), _zero(x)

    def init_cache(self, cfg: ModelConfig, batch: int, max_len: int,
                   device) -> Dict:
        return {"kv": attn_mod.init_kv_cache(cfg, batch, max_len,
                                             device=device)}

    def decode(self, x, cache: Dict, pos: int, cfg: ModelConfig,
               memory=None):
        """One token: self-attention from the cache (updated in place), then
        cross-attention against the whole memory."""
        h = rmsnorm(x, self.ln1, cfg.norm_eps)
        o, cache["kv"] = attn_mod.decode_attn_apply(self.attn, h,
                                                    cache["kv"], pos, cfg)
        return self._cross_and_mlp(x + o, cfg, memory), cache


REGISTRY: Dict[str, Callable[[ModelConfig, torch.device], nn.Module]] = {
    "attn": lambda cfg, device: AttnBlock(cfg, device, window=0),
    "local_attn": lambda cfg, device: AttnBlock(cfg, device,
                                                window=cfg.window),
    "moe": MoeBlock,
    "ssm": SsmBlock,
    "rglru": RglruBlock,
    "cross_attn": CrossAttnBlock,
    "enc_attn": lambda cfg, device: AttnBlock(cfg, device, causal=False),
}


def make_block(kind: str, cfg: ModelConfig, device) -> nn.Module:
    if kind not in REGISTRY:
        raise KeyError(f"unknown block kind {kind!r}")
    return REGISTRY[kind](cfg, device)
