"""Mamba2 mixer: separate in-projections -> causal depthwise convs -> SSD
scan -> gated RMSNorm -> out-projection, and its one-token decode step.

Counterpart of ``repro/models/ssm.py``.  Prefill runs the SSD scan through
``kernels.ssd.ssd_scan``: the hand-written kernel when ``use_flash_kernel``
is set, else the plain chunked version.  With ``cfg.ssd_shard_map`` under a
mesh whose "model" axis has more than one rank, the scan runs sharded over
the heads (``ssd_apply_shard_map``), as the reference's does.  The
reference's head blocks only shape its sharded lowering and are not ported.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn
from torch.nn import functional as F

from ..configs.base import ModelConfig
from ..distributed import sharding as shd
from ..device import DeviceLike, resolve_device
from .layers import dense_init, dtype_of, empty_param, pdtype_of, rmsnorm


def _dims(cfg: ModelConfig):
    di = cfg.d_inner
    n = cfg.ssm_state
    h = cfg.ssm_heads
    conv_ch = di + 2 * n
    return di, n, h, conv_ch


_XH = ("batch", "seq", "heads", None)
_BC = ("batch", "seq", None)

class SSM(nn.Module):
    """Parameters with the reference's leaf names (``ssm_init``): stream
    projections ``w_z``, ``w_xs`` (d, d_inner), ``w_b``, ``w_c`` (d, N),
    ``w_dtp`` (d, H); the depthwise conv ``conv_w`` (width, conv_ch) and
    ``conv_b``; ``a_log``, ``dt_bias``, ``d_skip`` (H,), which stay fp32
    whatever the param dtype, as in the reference; ``norm_scale``
    (d_inner,) and ``w_out`` (d_inner, d)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        di, n, h, conv_ch = _dims(cfg)
        d = cfg.d_model
        self.w_z = empty_param((d, di), cfg, device)
        self.w_xs = empty_param((d, di), cfg, device)
        self.w_b = empty_param((d, n), cfg, device)
        self.w_c = empty_param((d, n), cfg, device)
        self.w_dtp = empty_param((d, h), cfg, device)
        self.conv_w = empty_param((cfg.conv_width, conv_ch), cfg, device)
        self.conv_b = empty_param((conv_ch,), cfg, device)
        for name in ("a_log", "dt_bias", "d_skip"):
            setattr(self, name, empty_param((h,), cfg, device,
                                            dtype=torch.float32))
        self.norm_scale = empty_param((di,), cfg, device)
        self.w_out = empty_param((di, d), cfg, device)

    @torch.no_grad()
    def init(self, generator: torch.Generator, cfg: ModelConfig):
        """The reference's distributions (``ssm_init``)."""
        pd = pdtype_of(cfg)
        di, _, h, conv_ch = _dims(cfg)
        for w in (self.w_z, self.w_xs, self.w_b, self.w_c, self.w_dtp):
            w.copy_(dense_init(generator, *w.shape, pd))
        self.conv_w.copy_((torch.randn(
            (cfg.conv_width, conv_ch), generator=generator,
            device=generator.device) * 0.1).to(pd))
        self.conv_b.zero_()
        self.a_log.copy_(torch.log(torch.linspace(1.0, 16.0, h)))
        self.dt_bias.zero_()
        self.d_skip.fill_(1.0)
        self.norm_scale.fill_(1.0)
        self.w_out.copy_(dense_init(generator, di, cfg.d_model, pd,
                                    scale=cfg.residual_scale))


def _conv_split(p: SSM, cfg: ModelConfig):
    """Per-stream views (x, B, C) of the depthwise conv parameters."""
    di, n, _, _ = _dims(cfg)
    w, b = p.conv_w, p.conv_b
    return ((w[:, :di], b[:di]),
            (w[:, di:di + n], b[di:di + n]),
            (w[:, di + n:], b[di + n:]))


def _causal_conv(x, w, b, *, width: int):
    """Depthwise causal conv over seq, then SiLU: x (B, S, C)."""
    pad = F.pad(x, (0, 0, width - 1, 0))
    s = x.shape[1]
    out = sum(pad[:, j:j + s, :] * w[j][None, None, :] for j in range(width))
    return F.silu(out + b[None, None, :])


def ssm_apply(p: SSM, x, cfg: ModelConfig):
    """Prefill / forward over a whole sequence: x (B, S, d) -> (B, S, d)."""
    from ..kernels.ssd import ssd_scan
    dt_ = dtype_of(cfg)
    di, _, h, _ = _dims(cfg)
    b, s, _ = x.shape
    z = x @ p.w_z.to(dt_)
    xs = x @ p.w_xs.to(dt_)
    bmat = x @ p.w_b.to(dt_)
    cmat = x @ p.w_c.to(dt_)
    dt_raw = x @ p.w_dtp.to(dt_)

    (wx, bx), (wb, bb), (wc, bc) = _conv_split(p, cfg)
    xs = _causal_conv(xs, wx.to(dt_), bx.to(dt_), width=cfg.conv_width)
    bmat = _causal_conv(bmat, wb.to(dt_), bb.to(dt_), width=cfg.conv_width)
    cmat = _causal_conv(cmat, wc.to(dt_), bc.to(dt_), width=cfg.conv_width)

    xh = xs.reshape(b, s, h, cfg.ssm_headdim)
    dt = F.softplus(dt_raw.float() + p.dt_bias[None, None, :])
    xh = shd.constrain(xh, _XH)
    args = (xh.float(), dt, p.a_log, bmat.float(), cmat.float())
    mesh = shd.active_mesh()
    if cfg.ssd_shard_map and mesh is not None and shd.axis_size("model") > 1:
        def body(*a):
            return ssd_apply_shard_map(
                *a, cfg, mesh=mesh,
                dp_axes=shd.dp_axes_of(shd.current_rules()))
        # a rank's rows, every head: the region splits the heads itself
        rows = (("batch", "seq", None, None), ("batch", "seq", None),
                (None,), _BC, _BC)
        y = shd.per_shard(body, args, rows, rows[0], xh.shape,
                          reduces=("model",))
    else:
        def body(*a):
            return ssd_scan(*a, chunk=cfg.ssm_chunk,
                            use_kernel=cfg.use_flash_kernel)
        # per (batch row, head): local on each rank under a mesh
        y = shd.per_shard(body, args, (_XH, _XH[:3], ("heads",), _BC, _BC),
                          _XH, xh.shape)
    y = y + xh.float() * p.d_skip[None, None, :, None]
    y = y.reshape(b, s, di).to(dt_)
    y = rmsnorm(y * F.silu(z), p.norm_scale, cfg.norm_eps)
    return shd.constrain(y @ p.w_out.to(dt_), ("batch", "seq", "embed"))


def init_ssm_cache(cfg: ModelConfig, batch: int,
                   device: DeviceLike = None) -> Dict:
    """{"conv": (B, width-1, conv_ch) in the compute dtype, "ssm": (B, H,
    N, P) fp32}, zeros, on ``device`` (default: the card)."""
    _, n, h, conv_ch = _dims(cfg)
    dev = resolve_device(device)
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, conv_ch),
                            dtype=dtype_of(cfg), device=dev),
        "ssm": torch.zeros((batch, h, n, cfg.ssm_headdim),
                           dtype=torch.float32, device=dev),
    }


def ssm_decode(p: SSM, x, cache: Dict, pos, cfg: ModelConfig
               ) -> Tuple[torch.Tensor, Dict]:
    """One-token step: x (B, 1, d) -> (out (B, 1, d), cache).  ``pos`` is
    unused, as in the reference.  Both cache tensors are updated IN PLACE
    (the reference returns new ones) and the cache is returned."""
    dt_ = dtype_of(cfg)
    di, n, h, _ = _dims(cfg)
    b = x.shape[0]
    x0 = x[:, 0, :]
    z = x0 @ p.w_z.to(dt_)
    new = torch.cat([x0 @ p.w_xs.to(dt_), x0 @ p.w_b.to(dt_),
                     x0 @ p.w_c.to(dt_)], dim=-1)
    dt_raw = x0 @ p.w_dtp.to(dt_)

    hist = torch.cat([cache["conv"], new[:, None, :]], dim=1)
    conv_out = torch.einsum("bwc,wc->bc", hist, p.conv_w.to(dt_)) \
        + p.conv_b.to(dt_)
    xbc = F.silu(conv_out)

    xs = xbc[:, :di].reshape(b, h, cfg.ssm_headdim).float()
    bmat = xbc[:, di:di + n].float()
    cmat = xbc[:, di + n:].float()
    dt = F.softplus(dt_raw.float() + p.dt_bias[None, :])
    a = -torch.exp(p.a_log)                                   # (H,)
    da = torch.exp(dt * a[None, :])                           # (B, H)
    inc = dt[:, :, None, None] * bmat[:, None, :, None] * xs[:, :, None, :]
    ssm = cache["ssm"].mul_(da[:, :, None, None]).add_(inc)   # (B,H,N,P)
    cache["conv"].copy_(hist[:, 1:, :])
    y = torch.einsum("bn,bhnp->bhp", cmat, ssm)
    y = y + xs * p.d_skip[None, :, None]
    y = y.reshape(b, di).to(dt_)
    y = rmsnorm(y * F.silu(z), p.norm_scale, cfg.norm_eps)
    out = (y @ p.w_out.to(dt_))[:, None, :]
    return shd.constrain(out, ("batch", "seq", "embed")), cache


# ---------------------------------------------------------------------------
# Head-sharded SSD (the reference's shard_map path; cfg.ssd_shard_map).
#
# Everything the SSD needs is per-rank local: x heads and dt split over
# "model", the batch over the DP axes (each rank holds its rows), B/C
# replicated over "model".  So each rank scans its own heads with no
# collective, and the head blocks are gathered for the rest of the layer,
# whose gated norm runs over all of d_inner.  In the backward the gradients
# of the replicated B and C are summed over "model" and those of the head
# blocks gathered back (``distributed.sharding``).
# ---------------------------------------------------------------------------

def _ssd_local_body(xh, dt, a_log, bmat, cmat, *, chunk: int,
                    tile_dtype=None):
    """Per-rank: all local heads in one block, through the plain chunked
    scan (the reference's ``ssd_chunked_jnp``, not the kernel)."""
    from ..kernels.ssd import ref
    with shd.manual_region():
        return ref.ssd_chunked(xh, dt, a_log, bmat, cmat, chunk=chunk,
                               tile_dtype=tile_dtype)


def ssd_apply_shard_map(xh, dt, a_log, bmat, cmat, cfg: ModelConfig, *,
                        mesh, dp_axes, model_axis: str = "model"):
    """xh: (B, S, H, P); dt: (B, S, H); bmat/cmat: (B, S, N), every rank of
    a model group holding the same (its DP rows, all heads) -> y (B, S, H,
    P), the same on each.  ``dp_axes`` name the axes the batch is split
    over; the scan is per row, so no DP collective is needed."""
    group = mesh.get_group(model_axis)
    y = _ssd_local_body(
        shd.split_to(xh, 2, group), shd.split_to(dt, 2, group),
        shd.split_to(a_log, 0, group),
        shd.copy_to(bmat, group), shd.copy_to(cmat, group),
        chunk=cfg.ssm_chunk,
        tile_dtype=torch.bfloat16 if cfg.ssd_tile_bf16 else None)
    return shd.gather_from(y, 2, group)
