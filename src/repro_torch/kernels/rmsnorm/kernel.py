"""Wrapper of the hand-written Hopper RMSNorm (``csrc/rmsnorm.cu``), the port
of the TPU kernel ``repro/kernels/rmsnorm/kernel.py:rmsnorm_2d``.

CPU tensors take the plain version (``ref.rmsnorm``).  CUDA tensors launch
the kernel or raise; nothing falls back.  The kernel library is built with
nvcc and loaded with ctypes at the first CUDA call, never at import.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import ref

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_ALIGN = 16                    # the kernel moves 16-byte vectors
_INT_MAX = 2 ** 31 - 1

_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_int,
                                      ctypes.c_float, ctypes.c_int,
                                      ctypes.c_int, ctypes.c_void_p])

# Kernel launches; the wrapper adds one per launch and nowhere else.  A
# caller resets it to 0 before the run it wants to count.
launches = 0


def check_inputs(x, w) -> None:
    """Raise on anything the CUDA kernel does not take."""
    if x.dim() != 2:
        raise ValueError(f"x must be 2-D (R, D), got {tuple(x.shape)}")
    r, d = x.shape
    if tuple(w.shape) != (d,):
        raise ValueError(f"w must be ({d},), got {tuple(w.shape)}")
    for name, t in (("x", x), ("w", w)):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                            f"{sorted(map(str, _DTYPE_CODES))}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous (strides "
                             f"{t.stride()})")
        if t.data_ptr() % _ALIGN:
            raise ValueError(f"{name} is not {_ALIGN}-byte aligned (address "
                             f"{t.data_ptr():#x})")
    if w.device != x.device:
        raise ValueError(f"x on {x.device} and w on {w.device}")
    if d < 8 or d % 8 != 0 or d > _INT_MAX:
        raise ValueError(f"row width {d} is not a positive multiple of 8 "
                         f"(the op sends such rows to the plain version)")
    if r < 1:
        raise ValueError(f"empty input {tuple(x.shape)}")


def _entry():
    fn = _build.load("rmsnorm").rmsnorm_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def rmsnorm_2d(x, w, *, eps: float = 1e-6):
    """x: (R, D), w: (D,) -> (R, D) in x's dtype.

    The reference's TPU row block (``block_rows``) has no counterpart: the
    Hopper kernel gives a row of 136 to 8192 fp32 values (to 16384 bf16)
    one block of 256 threads that holds it in registers, and a narrower or
    wider row one warp."""
    global launches
    _build.refuse_autograd("rmsnorm", x, w)
    _build.refuse_traced("rmsnorm", x, w)
    if x.device.type == "cpu":
        return ref.rmsnorm(x, w, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"rmsnorm runs on cpu or cuda, not {x.device}")
    check_inputs(x, w)
    r, d = x.shape
    out = torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = _entry()(
            x.data_ptr(), w.data_ptr(), out.data_ptr(), r, d, float(eps),
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[w.dtype],
            torch.cuda.current_stream(x.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"rmsnorm kernel launch failed (code {err}) for x "
                           f"{tuple(x.shape)} {x.dtype}, w {w.dtype}")
    launches += 1
    return out
