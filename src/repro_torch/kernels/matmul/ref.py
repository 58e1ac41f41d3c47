"""Plain PyTorch version of the tiled matmul: the oracle the CUDA kernel is
held against, and the path CPU tensors take.  Counterpart of
``repro/kernels/matmul/ref.py``: both operands upcast to fp32, one fp32
product, the result cast to ``out_dtype`` (default ``a.dtype``)."""
from __future__ import annotations

import torch


def matmul(a, b, out_dtype=None):
    out = torch.matmul(a.to(torch.float32), b.to(torch.float32))
    return out.to(out_dtype or a.dtype)
