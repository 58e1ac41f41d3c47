"""Block-wise int8 quantized Adam moments (8-bit-Adam-style; Dettmers et
al.): m and v stored as int8 + fp32 scales per 256-element block, ~2.05
bytes a parameter for both moments against 8 (fp32) or 4 (bf16).

Counterpart of ``repro/optim/quantized_moments.py``, with the same names,
numerics and state layout.  m (signed) is quantized symmetric linear; v
(non-negative) in log space, affine over each block's range.  Each step
dequantizes, updates in fp32 and requantizes.

Parameters, gradients and moments are dicts of named tensors, as in
``optim.adamw``; an update writes the parameters and the moments' codes and
scales IN PLACE under ``torch.no_grad()``.  Where the reference runs the
update as one jitted function over its pytree, here it runs one leaf at a
time, and a leaf of more than ``SPLIT_ELEMS`` elements in slices along its
leading dims (the flat form: at block boundaries), so its fp32 temporaries
are those of one slice.  The slices give the same bits: the blocks lie
along the last axis (the flat form's within a slice).  The global-norm clip
is applied to each leaf inside the loop, with the reference's rounding,
instead of through a clipped copy of every gradient.

The reference stacks each block parameter over the model's groups, so a
per-group 0-d parameter (the cross-attention gate ``xgate``) is a (n,)
leaf there, and its moments are int8 blocks over that vector.  The ``nd``
functions do the same: 0-d parameters named as slices of one stacked leaf
(``models.convert.split_stacked``: ``groups.<g>.``, ``prefix.<i>.``,
``encoder.blocks.<i>.``) share moments, named by the leaf
(``groups.b0.xgate``), quantized over the stacked vector.  A 0-d parameter
outside a stack keeps fp32 moments, as in the reference.  Every parameter
of rank >= 1 blocks along its own last axis, as its stacked leaf does
group by group, so its codes are the reference's slice.
"""
from __future__ import annotations

import math
from typing import Dict, Iterator, List, Mapping, Tuple

import torch

from ..models.convert import split_stacked
from .adamw import global_norm_scale

BLOCK = 256
V_FLOOR = 1e-30
# the elements of one slice of a leaf the update holds in fp32 at a time
SPLIT_ELEMS = 1 << 26


def _pad_len(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


def _edge_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Pad the last axis with ``pad`` copies of its last column."""
    if not pad:
        return x
    return torch.cat([x, x[..., -1:].expand(*x.shape[:-1], pad)], dim=-1)


def quantize_signed(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (any shape, read flat) -> (int8 blocks (nb, 256), fp32 scales per
    block); the last block is padded with zeros."""
    flat = x.reshape(-1)
    xp = torch.nn.functional.pad(flat, (0, _pad_len(flat.numel())
                                        - flat.numel())).reshape(-1, BLOCK)
    scale = torch.clamp(xp.abs().amax(dim=1), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xp / scale[:, None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_signed(q, scale, shape) -> torch.Tensor:
    x = (q.float() * scale[:, None]).reshape(-1)
    return x[:math.prod(shape)].reshape(shape)


def _log_codes(xb: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Blocks (..., 256) of non-negative x -> (int8 codes, scales (..., 2)
    = [lmin, lrange] of each block's log)."""
    l = torch.log(torch.clamp(xb, min=V_FLOOR))
    lmin = l.amin(dim=-1)
    lrange = torch.clamp(l.amax(dim=-1) - lmin, min=1e-6)
    q = torch.clamp(torch.round(255.0 * (l - lmin[..., None])
                                / lrange[..., None]), 0, 255)
    return (q - 128).to(torch.int8), torch.stack([lmin, lrange], dim=-1)


def _log_decode(q, scales) -> torch.Tensor:
    lmin, lrange = scales[..., 0], scales[..., 1]
    l = lmin[..., None] + (q.float() + 128.0) / 255.0 * lrange[..., None]
    x = torch.exp(l)
    return torch.where(x <= V_FLOOR * 2.0, 0.0, x)


def quantize_nonneg(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """Non-negative x (second moment, read flat) -> int8 blocks in LOG
    space and packed scales (nb, 2) = [lmin, lrange].

    v spans many orders of magnitude; linear quantization flushes small
    entries to zero and mhat/(sqrt(0)+eps) explodes.  Log-space affine
    quantization keeps ~2.3% RELATIVE resolution across the block's range.
    The last block is padded with the last value: a constant would stretch
    its log range and destroy its resolution."""
    flat = x.reshape(-1)
    xp = _edge_pad(flat, _pad_len(flat.numel()) - flat.numel())
    return _log_codes(xp.reshape(-1, BLOCK))


def dequantize_nonneg(q, scales, shape) -> torch.Tensor:
    """Anything at or below ``2 * V_FLOOR`` reads back as 0."""
    x = _log_decode(q, scales).reshape(-1)
    return x[:math.prod(shape)].reshape(shape)


def moment_bytes_per_param() -> float:
    """2 int8 + (1 + 2) fp32 scale words per 256-block ~ 2.05
    bytes/param for both moments."""
    return 2.0 + 3.0 * 4.0 / BLOCK


# ---------------------------------------------------------------------------
# Shape-preserving block quantization: blocks live along the LAST axis only.
# q has shape p.shape[:-1] + (ceil(last/256), 256) and the scales
# p.shape[:-1] + (blocks, ...), so the leading dims keep the parameter's.
# ---------------------------------------------------------------------------

def _last_blocks(last: int) -> int:
    return -(-last // BLOCK)


def _pad_last(x: torch.Tensor) -> torch.Tensor:
    last = x.shape[-1]
    x = _edge_pad(x, _last_blocks(last) * BLOCK - last)
    return x.reshape(*x.shape[:-1], _last_blocks(last), BLOCK)


def quantize_signed_nd(x) -> Tuple[torch.Tensor, torch.Tensor]:
    xb = _pad_last(x.float())
    scale = torch.clamp(xb.abs().amax(dim=-1), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xb / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_signed_nd(q, scale, shape) -> torch.Tensor:
    x = q.float() * scale[..., None]
    return x.reshape(*shape[:-1], -1)[..., :shape[-1]]


def quantize_nonneg_nd(x) -> Tuple[torch.Tensor, torch.Tensor]:
    return _log_codes(_pad_last(x.float()))


def dequantize_nonneg_nd(q, scales, shape) -> torch.Tensor:
    return _log_decode(q, scales).reshape(*shape[:-1], -1)[..., :shape[-1]]


# ---------------------------------------------------------------------------
# The optimizer.
# ---------------------------------------------------------------------------

def _zero_v_scales(lead, device) -> torch.Tensor:
    """The scales zero v quantizes to, (*lead, 2): computed as the
    reference computes them (log of the floor), not written down."""
    _, s = quantize_nonneg_nd(torch.zeros((1, BLOCK), device=device))
    return s[0, 0].expand(*lead, 2).clone()


def q8_init(params: Mapping[str, torch.Tensor]) -> Dict:
    """Flat layout: each parameter's moments as (nb, 256) int8 blocks."""
    def zeros_m(p):
        nb = _pad_len(p.numel()) // BLOCK
        return {"q": torch.zeros((nb, BLOCK), dtype=torch.int8,
                                 device=p.device),
                "scale": torch.zeros((nb,), device=p.device)}

    def zeros_v(p):
        nb = _pad_len(p.numel()) // BLOCK
        return {"q": torch.full((nb, BLOCK), -128, dtype=torch.int8,
                                device=p.device),
                "scale": _zero_v_scales((nb,), p.device)}

    return {"mu": {k: zeros_m(p) for k, p in params.items()},
            "nu": {k: zeros_v(p) for k, p in params.items()},
            "step": _step0(params)}


def _step0(params) -> torch.Tensor:
    device = next(iter(params.values())).device
    return torch.zeros((), dtype=torch.int32, device=device)


def _leaves(params: Mapping[str, torch.Tensor]
            ) -> Iterator[Tuple[str, List[str]]]:
    """(moment name, the parameter names it covers), in the parameters'
    order: a 0-d parameter in a stacked part goes with the others of its
    stacked leaf, under the leaf's name, in index order; every other
    parameter is its own."""
    groups: Dict[str, List[Tuple[int, str]]] = {}
    for name, p in params.items():
        where = split_stacked(name) if p.dim() == 0 else None
        key, i = where or (name, 0)
        groups.setdefault(key, []).append((i, name))
    for key, members in groups.items():
        members.sort()
        if [i for i, _ in members] != list(range(len(members))):
            raise ValueError(f"{key}: indices {members} are not 0..n-1")
        yield key, [n for _, n in members]


def q8nd_init(params: Mapping[str, torch.Tensor]) -> Dict:
    """Shape-preserving layout: moments of a parameter of shape (..., L) as
    int8 (..., nb, 256) with fp32 scales (..., nb) for m and (..., nb, 2)
    for v; 0-d parameters outside a stack keep fp32 moments (``{"q"}``
    alone)."""
    mu, nu = {}, {}
    for key, names in _leaves(params):
        shape = tuple(params[key].shape) if key in params \
            else (len(names),)
        device = params[names[0]].device
        if not shape:
            mu[key] = {"q": torch.zeros((), device=device)}
            nu[key] = {"q": torch.zeros((), device=device)}
            continue
        lead, nb = shape[:-1], _last_blocks(shape[-1])
        mu[key] = {"q": torch.zeros((*lead, nb, BLOCK), dtype=torch.int8,
                                    device=device),
                   "scale": torch.zeros((*lead, nb), device=device)}
        nu[key] = {"q": torch.full((*lead, nb, BLOCK), -128,
                                   dtype=torch.int8, device=device),
                   "scale": _zero_v_scales((*lead, nb), device)}
    return {"mu": mu, "nu": nu, "step": _step0(params)}


class _Adam:
    """One step's constants and the fp32 update of one slice."""

    def __init__(self, state, grads, lr, b1, b2, eps, weight_decay,
                 max_grad_norm):
        self.step = state["step"] + 1
        self.lr = lr(self.step) if callable(lr) else lr
        if max_grad_norm > 0:
            self.gnorm, self.clip = global_norm_scale(grads, max_grad_norm)
        else:
            self.gnorm, self.clip = torch.zeros(
                (), device=self.step.device), None
        self.b1, self.b2, self.eps, self.wd = b1, b2, eps, weight_decay
        self.bc1 = 1.0 - b1 ** self.step.float()
        self.bc2 = 1.0 - b2 ** self.step.float()

    def __call__(self, p, g, m, v):
        """Write the updated slice into ``p`` and return the new (m, v),
        in the reference's order of operations."""
        if self.clip is not None:
            g = (g.float() * self.clip).to(g.dtype)
        gf = g.float()
        m = self.b1 * m + (1 - self.b1) * gf
        v = self.b2 * v + (1 - self.b2) * gf * gf
        delta = (m / self.bc1) / (torch.sqrt(v / self.bc2) + self.eps) \
            + self.wd * p.float()
        p.copy_(p.float() - self.lr * delta)
        return m, v

    def finish(self, state):
        state["step"] = self.step
        return {"grad_norm": self.gnorm, "lr": self.lr}


@torch.no_grad()
def q8_adamw_update(params: Mapping[str, torch.Tensor],
                    grads: Mapping[str, torch.Tensor], state: Dict, *, lr,
                    b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                    weight_decay: float = 0.1,
                    max_grad_norm: float = 1.0):
    """AdamW with int8 block-quantized moments in the flat layout.  Same
    contract as ``optim.adamw.adamw_update``: (params, state, metrics),
    updated in place."""
    adam = _Adam(state, grads, lr, b1, b2, eps, weight_decay, max_grad_norm)
    for name, p in params.items():
        mq, vq = state["mu"][name], state["nu"][name]
        pf, gf, n = p.view(-1), grads[name].reshape(-1), p.numel()
        chunk = max(SPLIT_ELEMS // BLOCK, 1) * BLOCK
        for e0 in range(0, n, chunk):
            e1 = min(n, e0 + chunk)
            blk = slice(e0 // BLOCK, _pad_len(e1) // BLOCK)
            m = dequantize_signed(mq["q"][blk], mq["scale"][blk], (e1 - e0,))
            v = dequantize_nonneg(vq["q"][blk], vq["scale"][blk], (e1 - e0,))
            m, v = adam(pf[e0:e1], gf[e0:e1], m, v)
            for dst, (q, s) in ((mq, quantize_signed(m)),
                                (vq, quantize_nonneg(v))):
                dst["q"][blk] = q
                dst["scale"][blk] = s
    return params, state, adam.finish(state)


@torch.no_grad()
def q8nd_adamw_update(params: Mapping[str, torch.Tensor],
                      grads: Mapping[str, torch.Tensor], state: Dict, *,
                      lr, b1: float = 0.9, b2: float = 0.95,
                      eps: float = 1e-8, weight_decay: float = 0.1,
                      max_grad_norm: float = 1.0):
    """AdamW with shape-preserving int8 moments (``q8nd_init``'s state).
    Same contract as
    ``optim.adamw.adamw_update``: (params, state, metrics), updated in
    place."""
    adam = _Adam(state, grads, lr, b1, b2, eps, weight_decay, max_grad_norm)
    for key, names in _leaves(params):
        mq, vq = state["mu"][key], state["nu"][key]
        if key in params:
            p, g = params[key], grads[key]
        else:                            # 0-d slices of one stacked leaf
            p = torch.stack([params[n] for n in names])
            g = torch.stack([grads[n] for n in names])
        if p.dim() == 0:
            m, v = adam(p, g, mq["q"], vq["q"])
            mq["q"].copy_(m)
            vq["q"].copy_(v)
            continue
        last = p.shape[-1]
        rows = p.numel() // last
        p2, g2 = p.view(rows, last), g.reshape(rows, last)
        qm, sm = (mq["q"].view(rows, *mq["q"].shape[-2:]),
                  mq["scale"].view(rows, -1))
        qv, sv = (vq["q"].view(rows, *vq["q"].shape[-2:]),
                  vq["scale"].view(rows, *vq["scale"].shape[-2:]))
        chunk = max(SPLIT_ELEMS // last, 1)
        for r0 in range(0, rows, chunk):
            r = slice(r0, min(rows, r0 + chunk))
            shape = (r.stop - r.start, last)
            m = dequantize_signed_nd(qm[r], sm[r], shape)
            v = dequantize_nonneg_nd(qv[r], sv[r], shape)
            m, v = adam(p2[r], g2[r], m, v)
            qm[r], sm[r] = quantize_signed_nd(m)
            qv[r], sv[r] = quantize_nonneg_nd(v)
        if key not in params:
            for i, n in enumerate(names):
                params[n].copy_(p[i])
    return params, state, adam.finish(state)
