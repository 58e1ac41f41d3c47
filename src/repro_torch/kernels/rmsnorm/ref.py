"""Plain PyTorch version of RMSNorm: the oracle the CUDA kernel is held
against, and the path CPU tensors take.  Counterpart of
``repro/kernels/rmsnorm/ref.py``: ``x * reciprocal(sqrt(mean(x^2) + eps))
* w`` in fp32, cast back to x's dtype."""
from __future__ import annotations

import torch


def rmsnorm(x, w, eps: float = 1e-6):
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.reciprocal(torch.sqrt(var + eps))
            * w.to(torch.float32)).to(x.dtype)
