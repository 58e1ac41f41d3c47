"""Plain PyTorch flash attention (naive materialised softmax): the oracle the
kernel is held against, and the path CPU tensors take.

Counterpart of ``repro/kernels/flash_attention/ref.py``."""
from __future__ import annotations

import torch


def attention(q, k, v, *, sm_scale: float, causal: bool = True,
              window: int = 0):
    """q: (B, Hq, S, D); k, v: (B, Hkv, S, D).  Exact reference: fp32
    scores over the whole (S, S) mask, output in q's dtype."""
    s = q.shape[2]
    group = q.shape[1] // k.shape[1]
    k = k.repeat_interleave(group, dim=1)
    v = v.repeat_interleave(group, dim=1)

    s_mat = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * sm_scale
    ids = torch.arange(s, device=q.device)
    q_ids = ids[:, None]
    k_ids = ids[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_ids <= q_ids
    if window > 0:
        mask &= k_ids >= q_ids - window
    # In place on the fresh (B, H, S, S) score tensor: at S = 8192 each copy
    # of it is 8 GiB per batch row.
    s_mat.masked_fill_(~mask, float("-inf"))
    p = s_mat.sub_(s_mat.amax(dim=-1, keepdim=True)).exp_()
    p.div_(p.sum(dim=-1, keepdim=True))
    out = torch.einsum("bhqk,bhkd->bhqd", p, v.float())
    return out.to(q.dtype)
