"""Block registry: per-kind block modules with ``init``, ``forward``,
``init_cache`` and ``decode``.  Counterpart of ``repro/models/blocks.py``.

Every block owns its norms and residual adds, and its ``forward`` returns
``(x, aux)``: the MoE block's load-balancing loss, a zero for the other
kinds, as in the reference.  Ported kinds:
  attn        full causal GQA attention + SwiGLU MLP
  local_attn  sliding-window GQA attention + MLP
  moe         (MLA or GQA) attention + MoE FFN
  ssm         Mamba2 mixer (SSD scan), no MLP
The other kinds of the reference raise ``NotImplementedError`` naming the
ROADMAP.md item that ports them.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import nn

from ..configs.base import ModelConfig
from . import attention as attn_mod
from . import mla as mla_mod
from . import moe as moe_mod
from . import ssm as ssm_mod
from .layers import MLP, empty_param, mlp_apply, rmsnorm

NOT_PORTED: Dict[str, str] = {
    "rglru": "ROADMAP.md Queue A: SSM / hybrid families",
    "cross_attn": "ROADMAP.md Queue A: encoder / cross-attention",
    "enc_attn": "ROADMAP.md Queue A: encoder / cross-attention",
}


def _zero(x):
    return torch.zeros((), dtype=torch.float32, device=x.device)


class AttnBlock(nn.Module):
    """``attn`` (window 0) and ``local_attn`` (window = cfg.window) blocks:
    parameters ``ln1``, ``attn`` and, when d_ff > 0, ``ln2`` and ``mlp``."""

    def __init__(self, cfg: ModelConfig, device, *, window: int = 0):
        super().__init__()
        self.window = window
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

    def forward(self, x, cfg: ModelConfig):
        h = rmsnorm(x, self.ln1, cfg.norm_eps)
        x = x + attn_mod.attn_apply(self.attn, h, cfg, window=self.window)
        if self.has_mlp:
            h = rmsnorm(x, self.ln2, cfg.norm_eps)
            x = x + mlp_apply(self.mlp, h, cfg)
        return x, _zero(x)

    def init_cache(self, cfg: ModelConfig, batch: int, max_len: int,
                   device) -> Dict:
        return {"kv": attn_mod.init_kv_cache(cfg, batch, max_len,
                                             window=self.window,
                                             device=device)}

    def decode(self, x, cache: Dict, pos: int, cfg: ModelConfig):
        """One token; updates ``cache`` in place and returns it."""
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

    def forward(self, x, cfg: ModelConfig):
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

    def decode(self, x, cache: Dict, pos: int, cfg: ModelConfig):
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

    def forward(self, x, cfg: ModelConfig):
        h = rmsnorm(x, self.ln1, cfg.norm_eps)
        return x + ssm_mod.ssm_apply(self.ssm, h, cfg), _zero(x)

    def init_cache(self, cfg: ModelConfig, batch: int, max_len: int,
                   device) -> Dict:
        return {"ssm": ssm_mod.init_ssm_cache(cfg, batch, device)}

    def decode(self, x, cache: Dict, pos: int, cfg: ModelConfig):
        """One token; updates ``cache`` in place and returns it."""
        h = rmsnorm(x, self.ln1, cfg.norm_eps)
        o, cache["ssm"] = ssm_mod.ssm_decode(self.ssm, h, cache["ssm"], pos,
                                             cfg)
        return x + o, cache


REGISTRY: Dict[str, Callable[[ModelConfig, torch.device], nn.Module]] = {
    "attn": lambda cfg, device: AttnBlock(cfg, device, window=0),
    "local_attn": lambda cfg, device: AttnBlock(cfg, device,
                                                window=cfg.window),
    "moe": MoeBlock,
    "ssm": SsmBlock,
}


def make_block(kind: str, cfg: ModelConfig, device) -> nn.Module:
    if kind in REGISTRY:
        return REGISTRY[kind](cfg, device)
    if kind in NOT_PORTED:
        raise NotImplementedError(
            f"block kind {kind!r} is not ported yet ({NOT_PORTED[kind]})")
    raise KeyError(f"unknown block kind {kind!r}")
