"""Public flash-attention op: the Hopper kernel on CUDA tensors at every
sequence length, its plain version on CPU tensors.  Counterpart of
``repro/kernels/flash_attention/ops.py``, whose Pallas kernel needs
S % 8 == 0 and sends other lengths to the plain version; the CUDA kernel
masks its ragged last tile instead."""
from __future__ import annotations

from typing import Optional

from . import kernel


def flash_attention(q, k, v, *, sm_scale: Optional[float] = None,
                    causal: bool = True, window: int = 0):
    """Batched multi-head attention with GQA, causal & sliding-window.

    q: (B, Hq, S, D); k, v: (B, Hkv, S, D) -> (B, Hq, S, D).  Strided views
    are passed to the kernel as they are (only the head dim must have stride
    1), so the model's (B, S, H, D) -> (B, H, S, D) transposes cost no copy.
    """
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    return kernel.mha(q, k, v, sm_scale=sm_scale, causal=causal,
                      window=window)
