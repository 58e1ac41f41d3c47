"""RG-LRU recurrent block (RecurrentGemma): conv1d + real-gated linear
recurrent unit, with a log-depth scan for prefill and training and an O(1)
decode step.

    r_t = sigmoid(blockdiag(W_r) x_t)          recurrence gate
    i_t = sigmoid(blockdiag(W_i) x_t)          input gate
    a_t = exp(-c * softplus(Lambda) * r_t)     per-channel decay, c = 8
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Counterpart of ``repro/models/rglru.py``.  The reference runs the
recurrence through ``jax.lax.associative_scan``, outside any Pallas kernel;
PyTorch has no eager associative scan, so ``_scan`` writes out the same
odd-even recursion in plain torch (log2(S) levels of halving size).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn
from torch.distributed.tensor import DTensor
from torch.nn import functional as F

from ..configs.base import ModelConfig
from ..distributed import sharding as shd
from ..distributed.sharding import constrain, per_shard
from .layers import dense_init, dtype_of, empty_param, pdtype_of

RGLRU_C = 8.0
N_GATE_BLOCKS = 8
CONV_WIDTH = 4


def _width(cfg: ModelConfig) -> int:
    return cfg.lru_width or cfg.d_model


class RGLRU(nn.Module):
    """Parameters with the reference's leaf names (``rglru_init``): the x and
    gate branches ``wx``, ``wy`` (d, W); the temporal conv ``conv_w`` (4, W)
    and ``conv_b``; the block-diagonal gates ``w_gates`` (2, 8, W/8, W/8)
    and ``b_gates`` (2, W); ``lam`` (W,), which stays fp32 whatever the
    param dtype, as in the reference; ``w_out`` (W, d)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        w = _width(cfg)
        bs = w // N_GATE_BLOCKS
        d = cfg.d_model
        self.wx = empty_param((d, w), cfg, device)
        self.wy = empty_param((d, w), cfg, device)
        self.conv_w = empty_param((CONV_WIDTH, w), cfg, device)
        self.conv_b = empty_param((w,), cfg, device)
        self.w_gates = empty_param((2, N_GATE_BLOCKS, bs, bs), cfg, device)
        self.b_gates = empty_param((2, w), cfg, device)
        self.lam = empty_param((w,), cfg, device, dtype=torch.float32)
        self.w_out = empty_param((w, d), cfg, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator, cfg: ModelConfig):
        """The reference's distributions: ``lam`` ~ U(2, 6), so that the
        decay a ~ U(0.9, 0.999) at r = 0.5."""
        pd = pdtype_of(cfg)
        w, d = self.wx.shape[1], cfg.d_model
        bs = w // N_GATE_BLOCKS

        def randn(*shape):
            return torch.randn(shape, generator=generator,
                               device=generator.device)
        self.wx.copy_(dense_init(generator, d, w, pd))
        self.wy.copy_(dense_init(generator, d, w, pd))
        self.conv_w.copy_((randn(CONV_WIDTH, w) * 0.1).to(pd))
        self.conv_b.zero_()
        self.w_gates.copy_((randn(2, N_GATE_BLOCKS, bs, bs)
                            * bs ** -0.5).to(pd))
        self.b_gates.zero_()
        self.lam.copy_(2.0 + 4.0 * torch.rand((w,), generator=generator,
                                              device=generator.device))
        self.w_out.copy_(dense_init(generator, w, d, pd,
                                    scale=cfg.residual_scale))


def _gates(w_gates, b_gates, x, lo: int = 0, hi=None):
    """x: (..., W) -> (r, i) each (..., hi - lo), fp32: channels [lo, hi)
    (default: all) of the block-diagonal projections, block n of x meeting
    ``w_gates[g, n]`` as in the reference's ``"...nb,gnbc->g...nc"``.  A
    range is whole blocks, or lies in one block (a rank's share when the
    blocks are fewer than the ranks)."""
    lead, w = x.shape[:-1], x.shape[-1]
    hi = w if hi is None else hi
    bs = w // N_GATE_BLOCKS
    n0, n1 = lo // bs, -(-hi // bs)
    c0, c1 = lo - n0 * bs, hi - (n1 - 1) * bs
    if n1 - n0 > 1 and (c0, c1) != (0, bs):
        raise ValueError(f"channels [{lo}, {hi}) cut gate blocks of {bs}")
    xb = x[..., n0 * bs:n1 * bs].reshape(-1, n1 - n0, bs).float()
    g = torch.einsum("tnb,gnbc->gtnc", xb,
                     w_gates[:, n0:n1, :, c0:c1].float())
    g = g.reshape(2, *lead, hi - lo) + b_gates[:, lo:hi].float().reshape(
        2, *([1] * len(lead)), hi - lo)
    return torch.sigmoid(g[0]), torch.sigmoid(g[1])


def _gates_placed(p: RGLRU, x):
    """``_gates`` of x (B, S, W); under a mesh each rank gathers its rows
    of x whole and computes the channels it holds ("ffn")."""
    if not isinstance(x, DTensor):
        return _gates(p.w_gates, p.b_gates, x)
    lanes = ("batch", "seq", "ffn")

    def body(x, w, b):
        rank, n_ranks = shd.logical_rank("ffn")
        width = x.shape[-1]
        share = -(-width // n_ranks)
        return _gates(w, b, x, rank * share, min((rank + 1) * share, width))
    return shd.per_shard(body, (x, p.w_gates, p.b_gates),
                         (("batch", "seq", None), (None,) * 4, (None, None)),
                         (lanes, lanes), (x.shape, x.shape))


def _decay(p: RGLRU, r):
    # torch's softplus is the identity above 20 (jax's is not); ``lam`` is
    # drawn from [2, 6], far below that.
    return torch.exp(-RGLRU_C * F.softplus(p.lam) * r)


def _conv(x, w, b):
    """Causal temporal conv over seq, no activation: x (B, S, W), left pad
    width - 1."""
    pad = F.pad(x, (0, 0, w.shape[0] - 1, 0))
    s = x.shape[1]
    out = sum(pad[:, j:j + s, :] * w[j][None, None, :]
              for j in range(w.shape[0]))
    return out + b[None, None, :]


def _scan(a, u):
    """h_t = a_t h_{t-1} + u_t along dim 1, h_{-1} = 0: the odd-even
    recursive scan (the scheme of ``jax.lax.associative_scan``).  Adjacent
    steps are combined pairwise, (a_{2i+1} a_{2i}, a_{2i+1} u_{2i} +
    u_{2i+1}), the half-length sequence is scanned, which gives h at the odd
    steps, and the even steps follow from them: log2(S) levels whose sizes
    halve, so the whole scan moves about as many bytes as a few passes over
    (a, u).  Out of place, so that autograd keeps every level's inputs."""
    s = a.shape[1]
    if s == 1:
        return u
    if s % 2:
        # one step more with a = 1, u = 0 keeps h; dropped at the end
        pad = (0, 0) * (a.dim() - 2) + (0, 1)
        return _scan(F.pad(a, pad, value=1.0), F.pad(u, pad))[:, :s]
    a0, a1 = a[:, 0::2], a[:, 1::2]
    u0, u1 = u[:, 0::2], u[:, 1::2]
    h_odd = _scan(a1 * a0, torch.addcmul(u1, a1, u0))
    h_even = torch.cat([u0[:, :1], torch.addcmul(u0[:, 1:], a0[:, 1:],
                                                 h_odd[:, :-1])], dim=1)
    return torch.stack([h_even, h_odd], dim=2).reshape(u.shape)


def _gate_branch(p: RGLRU, x, dt):
    # jax.nn.gelu is the tanh approximation by default; torch's is erf
    return F.gelu(x @ p.wy.to(dt), approximate="tanh")


def rglru_apply(p: RGLRU, x, cfg: ModelConfig):
    """x: (B, S, D) -> (B, S, D)."""
    dt = dtype_of(cfg)
    xb = x @ p.wx.to(dt)                           # (B, S, W)
    gate = _gate_branch(p, x, dt)
    xb = _conv(xb, p.conv_w.to(dt), p.conv_b.to(dt))
    r, i = _gates_placed(p, xb)
    a = _decay(p, r)                               # (B, S, W) fp32
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    u = beta * i * xb.float()
    # per (batch row, channel): local on each rank under a mesh
    lanes = ("batch", "seq", "ffn")
    h = per_shard(_scan, (a, u), (lanes, lanes), lanes, u.shape)
    h = constrain(h.to(dt), lanes)
    return constrain((h * gate) @ p.w_out.to(dt), ("batch", "seq", "embed"))


def init_rglru_cache(cfg: ModelConfig, batch: int, device=None) -> Dict:
    """``h`` (B, W) fp32, the recurrence; ``conv`` (B, 3, W), the conv's
    last three inputs, in the compute dtype."""
    w = _width(cfg)
    return {"h": torch.zeros((batch, w), dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, CONV_WIDTH - 1, w),
                                dtype=dtype_of(cfg), device=device)}


def rglru_decode(p: RGLRU, x, cache: Dict, pos: int, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, Dict]:
    """One token.  x: (B, 1, D); returns (out (B, 1, D), cache), the cache
    updated IN PLACE (the reference returns a new one)."""
    dt = dtype_of(cfg)
    xb = (x @ p.wx.to(dt))[:, 0, :]               # (B, W)
    gate = _gate_branch(p, x, dt)[:, 0, :]
    hist = torch.cat([cache["conv"], xb[:, None, :]], dim=1)
    conv = torch.einsum("bwc,wc->bc", hist, p.conv_w.to(dt)) \
        + p.conv_b.to(dt)
    r, i = _gates(p.w_gates, p.b_gates, conv)
    a = _decay(p, r)
    beta = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12))
    h = cache["h"].mul_(a).add_(beta * i * conv.float())
    cache["conv"].copy_(hist[:, 1:, :])
    out = ((h.to(dt) * gate) @ p.w_out.to(dt))[:, None, :]
    return constrain(out, ("batch", "seq", "embed")), cache
