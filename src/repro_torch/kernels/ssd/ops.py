"""Public SSD op with the reference's dispatch: the exact scan for lengths
the chunk does not divide, else the kernel or the plain chunked version.
Counterpart of ``repro/kernels/ssd/ops.py``."""
from __future__ import annotations

from . import kernel, ref


def ssd_scan(x, dt, a_log, b, c, *, chunk: int = kernel.DEFAULT_CHUNK,
             use_kernel: bool = True):
    """Mamba2 SSD: x (B,S,H,P), dt (B,S,H) > 0, a_log (H,), b/c (B,S,N).

    Paths: the kernel (``use_kernel``; its plain version on CPU tensors) >
    plain chunked > exact sequential scan (lengths the chunk does not
    divide).  The reference's ``unroll_heads`` and ``head_blocks`` only
    shape XLA's lowering and have no counterpart here."""
    s = x.shape[1]
    eff_chunk = min(chunk, s)
    if s % eff_chunk != 0:
        return ref.ssd_scan_ref(x, dt, a_log, b, c)
    if use_kernel:
        return kernel.ssd(x, dt, a_log, b, c, chunk=eff_chunk)
    return ref.ssd_chunked(x, dt, a_log, b, c, chunk=eff_chunk)
