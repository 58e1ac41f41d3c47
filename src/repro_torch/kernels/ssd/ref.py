"""Plain PyTorch versions of the Mamba2 SSD recurrence: the oracles the CUDA
kernel is held against, and the paths CPU tensors take.

``ssd_scan_ref``  exact sequential per-timestep recurrence (ground truth).
``ssd_chunked``   chunked SSD (arXiv:2405.21060, Alg. 1): per-chunk
                  quadratic term plus a state carried from chunk to chunk.
                  The kernel's oracle, and the model's path when
                  ``use_flash_kernel`` is off.

Counterpart of ``repro/kernels/ssd/ref.py``.  Of ``ssd_chunked_jnp``'s
options, ``tile_dtype`` is kept (the sharded path's bf16 tiles);
``unroll_heads`` only served XLA's dry-run cost accounting and the
``constrain`` calls only GSPMD's sharding.  Head blocks are not needed
either: at mamba2-1.3b's prefill shape (64 heads, 32 chunks of 256) all
heads' (L, L) decay tiles together take 0.5 GB.
"""
from __future__ import annotations

import torch


def ssd_scan_ref(x, dt, a_log, b, c):
    """Exact per-timestep recurrence, in fp32.

    x: (B, S, H, P); dt: (B, S, H); a_log: (H,); b, c: (B, S, N).
    Returns (B, S, H, P) in x's dtype."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    a = -torch.exp(a_log.float())                              # (H,)
    xf, dtf, bf, cf = x.float(), dt.float(), b.float(), c.float()
    state = torch.zeros((bsz, h, n, p), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(s):
        dt_t = dtf[:, t]                                       # (B, H)
        da = torch.exp(dt_t * a)                               # (B, H)
        inc = dt_t[:, :, None, None] * bf[:, t, None, :, None] \
            * xf[:, t, :, None, :]                             # (B, H, N, P)
        state = da[:, :, None, None] * state + inc
        ys.append(torch.einsum("bn,bhnp->bhp", cf[:, t], state))
    return torch.stack(ys, dim=1).to(x.dtype)


def ssd_chunked(x, dt, a_log, b, c, *, chunk: int = 128, tile_dtype=None):
    """Chunked SSD, all heads at once; S must be a multiple of ``chunk``.
    ``tile_dtype`` (e.g. torch.bfloat16): the dtype the two intra-chunk
    products take their operands in (C and B for the scores, the masked
    scores and dt * x), accumulating in fp32, as the reference's
    ``preferred_element_type``.

    Within a chunk, with g = cumsum(dt * A) and A = -exp(a_log):
        y_i = exp(g_i) C_i h_in + sum_{j <= i} (C_i . B_j) exp(g_i - g_j)
              dt_j x_j
    and the state carried into the next chunk is
        h_out = exp(g_last) h_in + sum_j B_j^T exp(g_last - g_j) dt_j x_j.
    The reference runs the carry as an associative scan; here it is a loop
    over the chunks, the order the TPU kernel's sequential grid axis
    takes."""
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    nc = s // chunk
    if nc * chunk != s:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {chunk}")
    a = -torch.exp(a_log.float())                              # (H,)
    xf = x.float().reshape(bsz, nc, chunk, h, p)
    dtf = dt.float().reshape(bsz, nc, chunk, h)
    bf = b.float().reshape(bsz, nc, chunk, n)
    cf = c.float().reshape(bsz, nc, chunk, n)

    g = torch.cumsum(dtf * a, dim=2).permute(0, 1, 3, 2)       # (B,nc,H,L)
    g_last = g[..., -1]                                        # (B,nc,H)
    dth = dtf.permute(0, 1, 3, 2)                              # (B,nc,H,L)
    xh = xf.permute(0, 1, 3, 2, 4)                             # (B,nc,H,L,P)

    # intra-chunk quadratic term.  Mask BEFORE exp: the masked (j > i)
    # entries have g_i - g_j > 0 and would overflow.
    def tile(t):        # a product's operand, rounded to tile_dtype
        return t if tile_dtype is None else t.to(tile_dtype).float()

    cb = torch.einsum("bcin,bcjn->bcij", tile(cf), tile(bf))   # (B,nc,L,L)
    live = torch.ones((chunk, chunk), dtype=torch.bool,
                      device=x.device).tril()
    seg = g[..., :, None] - g[..., None, :]                    # (B,nc,H,L,L)
    lmat = torch.exp(torch.where(live, seg, -1e30))
    y = tile(cb[:, :, None] * lmat) @ tile(xh * dth[..., None])  # (B,nc,H,L,P)

    # per-chunk state contributions, then the carry across chunks
    decay_state = torch.exp(g_last[..., None] - g)             # (B,nc,H,L)
    inc = torch.einsum("bcln,bchl,bchlp->bchnp", bf, dth * decay_state,
                       xh)                                     # (B,nc,H,N,P)
    chunk_decay = torch.exp(g_last)                            # (B,nc,H)
    state = torch.zeros_like(inc[:, 0])
    h_in = []
    for ci in range(nc):
        h_in.append(state)
        state = state * chunk_decay[:, ci, :, None, None] + inc[:, ci]
    h_in = torch.stack(h_in, dim=1)                            # (B,nc,H,N,P)

    y = y + torch.einsum("bcln,bchl,bchnp->bchlp", cf, torch.exp(g), h_in)
    return y.permute(0, 1, 3, 2, 4).reshape(bsz, s, h, p).to(x.dtype)
