"""AdamW with dtype-configurable moments and global-norm clipping.

Counterpart of ``repro/optim/adamw.py``.  Parameters, gradients and moments
are dicts of named tensors (``dict(model.named_parameters())``); the update
writes the new values into the parameters and moments IN PLACE under
``torch.no_grad()`` and returns them, in the reference's
``(params, state, metrics)`` shape.  The numerics are the reference's: an
int32 step counter, bias corrections in fp32, the update in fp32, results
cast back to each tensor's dtype.  ``torch.optim.AdamW`` has no
``eps_root`` and rounds in another order, so it is not used.
"""
from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor

from ..distributed.sharding import zeros_as


def adamw_init(params: Mapping[str, torch.Tensor], *,
               moment_dtype: Optional[str] = None) -> Dict:
    """Zero moments in ``moment_dtype`` (default: each parameter's dtype)
    and a 0-dim int32 step on the parameters' device."""
    md = getattr(torch, moment_dtype) if moment_dtype else None

    def zeros(p):
        return zeros_as(p, md or p.dtype)

    device = next(iter(params.values())).device
    return {"mu": {k: zeros(p) for k, p in params.items()},
            "nu": {k: zeros(p) for k, p in params.items()},
            "step": torch.zeros((), dtype=torch.int32, device=device)}


# a leaf above this many elements is squared and summed in slices of it, so
# that its fp32 copy is one slice's (a 1e9-element embedding's would be
# 4.2 GB, twice over)
NORM_SLICE = 1 << 26


def _square_sum(g: torch.Tensor) -> torch.Tensor:
    # a DTensor's fp32 copy is of its rank's block, sliced already
    if g.numel() <= NORM_SLICE or isinstance(g, DTensor):
        return torch.sum(torch.square(g.float()))
    flat = g.reshape(-1)
    return sum(torch.sum(torch.square(flat[i:i + NORM_SLICE].float()))
               for i in range(0, flat.numel(), NORM_SLICE))


def global_norm_scale(grads: Mapping[str, torch.Tensor], max_norm: float
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(the global norm of ``grads``, the factor that scales them to a norm
    of at most ``max_norm``).  In fp32, leaves summed in order."""
    gnorm = torch.sqrt(sum(_square_sum(g) for g in grads.values()))
    return gnorm, torch.clamp(max_norm / torch.clamp(gnorm, min=1e-12),
                              max=1.0)


def clip_by_global_norm(grads: Mapping[str, torch.Tensor], max_norm: float
                        ) -> Tuple[Dict, torch.Tensor]:
    """(grads scaled to a global norm of at most ``max_norm``, the global
    norm before scaling)."""
    gnorm, scale = global_norm_scale(grads, max_norm)
    return ({k: (g.float() * scale).to(g.dtype) for k, g in grads.items()},
            gnorm)


@torch.no_grad()
def adamw_update(params: Mapping[str, torch.Tensor],
                 grads: Mapping[str, torch.Tensor], state: Dict, *, lr,
                 b1: float = 0.9, b2: float = 0.95, eps: float = 1e-8,
                 eps_root: float = 0.0,
                 weight_decay: float = 0.1,
                 max_grad_norm: float = 1.0) -> Tuple[Mapping, Dict, Dict]:
    """Returns (params, state, metrics), params and moments updated in
    place.  lr may be a scalar or a callable step -> lr.

    ``eps_root`` is added inside the square root (optax semantics, default
    off): a nonzero value bounds the update's sensitivity to gradient
    noise when the second moment is near zero, so two gradient estimates
    that agree to fp32 round-off (accumulated microbatches against the full
    batch, the card against the CPU) give updates that agree as closely.
    The train step opts in (``train_step.EPS_ROOT``)."""
    step = state["step"] + 1
    lr_t = lr(step) if callable(lr) else lr
    if max_grad_norm > 0:
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
    else:
        gnorm = torch.zeros((), device=step.device)

    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()

    for name, p in params.items():
        m, v = state["mu"][name], state["nu"][name]
        gf = grads[name].float()
        mf = b1 * m.float() + (1 - b1) * gf
        vf = b2 * v.float() + (1 - b2) * gf * gf
        mhat = mf / bc1
        vhat = vf / bc2
        delta = mhat / (torch.sqrt(vhat + eps_root) + eps) \
            + weight_decay * p.float()
        p.copy_(p.float() - lr_t * delta)
        m.copy_(mf)
        v.copy_(vf)
    state["step"] = step
    return params, state, {"grad_norm": gnorm, "lr": lr_t}
