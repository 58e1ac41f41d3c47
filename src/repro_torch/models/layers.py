"""Shared layers: init helpers, RMSNorm, rotary embeddings, SwiGLU MLP.

Counterpart of ``repro/models/layers.py``.  Weights keep the reference's
``(in, out)`` layout and are applied as ``x @ W``.  The reference's
``constrain`` hints stand where its do: they return a plain tensor as it
is, and redistribute a DTensor under ``distributed.sharding.use_mesh``.
"""
from __future__ import annotations

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..distributed.sharding import constrain


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def pdtype_of(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.param_dtype)


def dense_init(generator: torch.Generator, d_in: int, d_out: int, dtype,
               scale: float = 1.0):
    """N(0, (scale / sqrt(d_in))^2), drawn on the generator's device."""
    std = scale * (d_in ** -0.5)
    return (torch.randn((d_in, d_out), generator=generator,
                        device=generator.device) * std).to(dtype)


def embed_init(generator: torch.Generator, vocab: int, d: int, dtype):
    return (torch.randn((vocab, d), generator=generator,
                        device=generator.device) * 0.02).to(dtype)


def empty_param(shape, cfg: ModelConfig, device,
                dtype: torch.dtype = None) -> nn.Parameter:
    """A parameter of ``shape``, filled later by an ``init`` or a weight
    load.  Its dtype is the config's parameter dtype unless ``dtype`` pins
    it, as the reference pins a few leaves to fp32 whatever the config
    says; ``convert.params_from_jax`` loads each leaf at the dtype given
    here."""
    return nn.Parameter(torch.empty(shape, dtype=dtype or pdtype_of(cfg),
                                    device=device), requires_grad=False)


def rmsnorm(x, scale, eps: float = 1e-6):
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps) * scale.float()
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float):
    """x: (B, S, H, D_even); positions: (B, S) or (S,).  Halves, not
    interleaved pairs: dim i rotates with dim i + D/2."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, device=x.device)          # (d/2,)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs              # (B, S, d/2)
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

class MLP(nn.Module):
    """Parameters ``wg``, ``wu`` (d_model, width) and ``wd`` (width,
    d_model), as in the reference's ``mlp_init``; width defaults to d_ff
    (MoE's shared experts give their own)."""

    def __init__(self, cfg: ModelConfig, device, width: int = 0):
        super().__init__()
        width = width or cfg.d_ff
        self.wg = empty_param((cfg.d_model, width), cfg, device)
        self.wu = empty_param((cfg.d_model, width), cfg, device)
        self.wd = empty_param((width, cfg.d_model), cfg, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator, cfg: ModelConfig):
        pd = pdtype_of(cfg)
        d, width = self.wg.shape
        self.wg.copy_(dense_init(generator, d, width, pd))
        self.wu.copy_(dense_init(generator, d, width, pd))
        self.wd.copy_(dense_init(generator, width, d, pd,
                                 scale=cfg.residual_scale))


def mlp_apply(p: MLP, x, cfg: ModelConfig):
    dt = dtype_of(cfg)
    h = nn.functional.silu(x @ p.wg.to(dt)) * (x @ p.wu.to(dt))
    h = constrain(h, ("batch", "seq", "ffn"))
    return constrain(h @ p.wd.to(dt), ("batch", "seq", "embed"))


def softcap(x, cap: float):
    if cap <= 0:
        return x
    return cap * torch.tanh(x / cap)
