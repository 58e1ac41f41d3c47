"""Wrapper of the hand-written Hopper SSD scan (``csrc/ssd.cu``), the port of
the TPU kernel ``repro/kernels/ssd/kernel.py:ssd``.

CPU tensors take the plain version (``ref.ssd_chunked`` at the same chunk).
CUDA tensors launch the kernel or raise; nothing falls back.  The kernel
library is built with nvcc and loaded with ctypes at the first CUDA call,
never at import.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import ref

DEFAULT_CHUNK = 128
MAX_CHUNK = 256
STATE_HEAD_DIMS = ((128, 64), (16, 16))    # (N, P) the kernel is built for
_MAX_GRID_YZ = 65535                       # heads and batch ride grid.y, .z

_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]

# Kernel launches (one per call, which runs the kernel's three passes); the
# wrapper adds one per launch and nowhere else.  A caller resets it to 0
# before the run it wants to count.
launches = 0


def check_inputs(x, dt, a_log, b, c, chunk: int) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if x.dim() != 4:
        raise ValueError(f"x must be 4-D (B, S, H, P), got {tuple(x.shape)}")
    bsz, s, h, p = x.shape
    n = b.shape[-1] if b.dim() == 3 else -1
    want = {"dt": (bsz, s, h), "a_log": (h,), "b": (bsz, s, n),
            "c": (bsz, s, n)}
    for name, t in (("x", x), ("dt", dt), ("a_log", a_log), ("b", b),
                    ("c", c)):
        if t.dtype != torch.float32:
            raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                            f"torch.float32 only")
        if t.device != x.device:
            raise ValueError("x, dt, a_log, b and c must share a device")
        if name != "x" and tuple(t.shape) != want[name]:
            raise ValueError(f"{name} must be {want[name]}, got "
                             f"{tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if name in ("x", "b", "c") and t.data_ptr() % 16:
            raise ValueError(f"{name} must start on a 16-byte boundary: "
                             f"the kernel copies its rows 16 bytes at a "
                             f"time")
    if (n, p) not in STATE_HEAD_DIMS:
        raise ValueError(f"state dim N={n} with head dim P={p} has no kernel "
                         f"instantiation; instantiated (N, P): "
                         f"{STATE_HEAD_DIMS}")
    if not 1 <= chunk <= MAX_CHUNK:
        raise ValueError(f"chunk {chunk} outside the kernel's [1, "
                         f"{MAX_CHUNK}]")
    if s % chunk != 0:
        raise ValueError(f"sequence length {s} is not a multiple of the "
                         f"chunk {chunk}")
    if bsz == 0 or h == 0:
        raise ValueError(f"empty SSD input {tuple(x.shape)}")
    if bsz > _MAX_GRID_YZ or h > _MAX_GRID_YZ:
        raise ValueError(f"batch {bsz} or heads {h} above {_MAX_GRID_YZ}")


def _entry():
    fn = _build.load("ssd").ssd_scan_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def ssd(x, dt, a_log, b, c, *, chunk: int = DEFAULT_CHUNK):
    """x: (B, S, H, P); dt: (B, S, H) (post-softplus, > 0); a_log: (H,)
    (A = -exp(a_log)); b, c: (B, S, N).  Returns (B, S, H, P) in x's dtype.
    S must be a multiple of min(chunk, S)."""
    global launches
    _build.refuse_autograd("SSD scan", x, dt, a_log, b, c)
    _build.refuse_traced("SSD scan", x, dt, a_log, b, c)
    chunk = min(chunk, x.shape[1])
    if x.device.type == "cpu":
        return ref.ssd_chunked(x, dt, a_log, b, c, chunk=chunk)
    if x.device.type != "cuda":
        raise ValueError(f"the SSD scan runs on cpu or cuda, not {x.device}")
    check_inputs(x, dt, a_log, b, c, chunk)
    bsz, s, h, p = x.shape
    n = b.shape[-1]
    y = torch.empty_like(x)
    # Scratch: g = cumsum(dt * A) per chunk, and each chunk's state.  They
    # are dropped when this returns, before the kernel has run; PyTorch's
    # caching allocator hands their blocks out again only to work queued
    # after it on the same stream.
    g = torch.empty((bsz, h, s), dtype=torch.float32, device=x.device)
    states = torch.empty((bsz, h, s // chunk, n, p), dtype=torch.float32,
                         device=x.device)
    with torch.cuda.device(x.device):
        err = _entry()(
            x.data_ptr(), dt.data_ptr(), a_log.data_ptr(), b.data_ptr(),
            c.data_ptr(), y.data_ptr(), g.data_ptr(), states.data_ptr(),
            bsz, s, h, p, n, chunk,
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"ssd kernel launch failed (code {err}) for x "
                           f"{tuple(x.shape)}, N={n}, chunk {chunk}")
    launches += 1
    return y
