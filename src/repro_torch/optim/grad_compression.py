"""Int8 error-feedback gradient compression for the cross-pod all-reduce.

Wire format: per-tensor symmetric int8 quantization (scale = max|g|/127).
Error feedback: the quantization residual is added back into the next
step's gradient, so compression bias does not accumulate (Karimireddy et
al., "Error Feedback Fixes SignSGD").

Counterpart of ``repro/optim/grad_compression.py``, over dicts of named
tensors.  ``torch.round`` rounds half to even, as ``jnp.round`` does, so
both packages give the same bits.  On one card nothing crosses a wire; the
step applies what the wire would deliver.
"""
from __future__ import annotations

from typing import Dict, Mapping, Tuple

import torch


def compress_int8(g) -> Tuple[torch.Tensor, torch.Tensor]:
    """g -> (int8 tensor, 0-dim fp32 scale)."""
    gf = g.float()
    scale = torch.clamp(gf.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return q, scale


def decompress_int8(q, scale):
    return q.float() * scale


def error_feedback_update(grads: Mapping[str, torch.Tensor],
                          residuals: Mapping[str, torch.Tensor]
                          ) -> Tuple[Dict, Dict]:
    """Quantize (grads + residuals); return (decompressed grads for the
    optimizer — what the wire would deliver — and new residuals)."""
    out, new_res = {}, {}
    for name, g in grads.items():
        corrected = g.float() + residuals[name]
        q, s = compress_int8(corrected)
        deq = decompress_int8(q, s)
        out[name] = deq.to(g.dtype)
        new_res[name] = corrected - deq
    return out, new_res


def init_residuals(grads: Mapping[str, torch.Tensor]) -> Dict:
    return {name: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
            for name, g in grads.items()}
