"""Public RMSNorm op: flattens leading dims, dispatches the kernel or the
plain version.  Counterpart of ``repro/kernels/rmsnorm/ops.py``."""
from __future__ import annotations

from . import kernel, ref


def rmsnorm(x, w, *, eps: float = 1e-6):
    """x: (..., D), w: (D,)."""
    d = x.shape[-1]
    if x.ndim < 2 or d % 8 != 0:
        return ref.rmsnorm(x, w, eps=eps)
    lead = x.shape[:-1]
    x2 = x.reshape(-1, d)
    out = kernel.rmsnorm_2d(x2, w, eps=eps)
    return out.reshape(*lead, d)
