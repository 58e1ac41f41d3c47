"""Wrapper of the hand-written Hopper tiled matmul (``csrc/matmul.cu``), the
port of the TPU kernel ``repro/kernels/matmul/kernel.py:matmul_tiled``.

CPU tensors take the plain version (``ref.matmul``).  CUDA tensors launch
the kernel or raise; nothing falls back.  The kernel library is built with
nvcc and loaded with ctypes at the first CUDA call, never at import.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import ref

# The reference's TPU VMEM block shapes, kept in the signature.
DEFAULT_BM = 256
DEFAULT_BN = 256
DEFAULT_BK = 512
BK = 64                        # K slice of every Hopper tile
# The (bm, bn) output tiles the source instantiates, by input dtype: fp32
# has no 128 x 256 or 256 x 128 (their rings exceed an SM's shared memory;
# csrc/matmul.cu's header).
TILES = {
    torch.float32: ((64, 64), (64, 128), (128, 64), (128, 128)),
    torch.bfloat16: ((64, 64), (64, 128), (128, 64), (128, 128),
                     (128, 256), (256, 128)),
}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_INT_MAX = 2 ** 31 - 1

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]

# Kernel launches; the wrapper adds one per launch and nowhere else.  A
# caller resets it to 0 before the run it wants to count.
launches = 0


def hopper_tile(m: int, n: int, bm: int = DEFAULT_BM, bn: int = DEFAULT_BN,
                dtype=torch.float32) -> tuple:
    """The instantiated (bm, bn) output tile that the block shape (bm, bn)
    launches for ``dtype`` inputs: the tile itself where it is
    instantiated (``select_blocks`` returns such tiles); else, for the
    reference's TPU block shapes, both clamped to the product's (m, n) as
    the reference clamps them, then the largest instantiated square tile
    that fits inside both (128 x 128 when each is at least 128, else
    64 x 64)."""
    if bm < 1 or bn < 1:
        raise ValueError(f"block shape bm={bm}, bn={bn} must be positive")
    tiles = TILES[dtype]
    if (bm, bn) in tiles:
        return bm, bn
    side = min(bm, m, bn, n)
    squares = [t for t, u in tiles if t == u]
    fitting = [t for t in squares if t <= side]
    t = max(fitting) if fitting else min(squares)
    return t, t


def check_inputs(a, b, out_dtype) -> None:
    """Raise on anything the CUDA kernel does not take."""
    for name, t in (("a", a), ("b", b)):
        if t.dim() != 2:
            raise ValueError(f"{name} must be 2-D, got {tuple(t.shape)}")
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                            f"{sorted(map(str, _DTYPE_CODES))}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be row-major contiguous (strides "
                             f"{t.stride()})")
    if a.dtype != b.dtype or a.device != b.device:
        raise ValueError(f"a and b must share dtype and device: {a.dtype} "
                         f"on {a.device}, {b.dtype} on {b.device}")
    if out_dtype not in _DTYPE_CODES:
        raise TypeError(f"out_dtype {out_dtype} not in "
                        f"{sorted(map(str, _DTYPE_CODES))}")
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner dims differ: a {tuple(a.shape)}, b "
                         f"{tuple(b.shape)}")
    if min(m, n, k) < 1:
        raise ValueError(f"empty product ({m}, {k}) @ ({k2}, {n})")
    if max(m, n, k) > _INT_MAX:
        raise ValueError(f"product ({m}, {k}) @ ({k2}, {n}) above the "
                         f"kernel's index range")


def _entry():
    fn = _build.load("matmul").matmul_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def matmul_tiled(a, b, *, bm: int = DEFAULT_BM, bn: int = DEFAULT_BN,
                 bk: int = DEFAULT_BK, out_dtype=None):
    """a: (M, K) @ b: (K, N) -> (M, N), fp32 accumulation, cast to
    ``out_dtype`` (default ``a.dtype``).

    ``bm``/``bn`` choose one of the instantiated Hopper output tiles
    (``hopper_tile``): an instantiated tile is launched as given, the
    reference's TPU block shapes map to a square one.  ``bk`` is the TPU's
    VMEM depth along K and has no counterpart: every Hopper tile streams K
    through shared memory in 64-deep slices (``BK``).  The
    products run on the tensor cores: bf16 mma.sync for bf16 inputs,
    3xTF32 mma.sync (each element split into two TF32 parts, three
    products) for fp32.  Every tile gives the same bits: each output takes
    the same sequence of mma instructions over k in increasing order,
    whatever the tile."""
    global launches
    _build.refuse_autograd("matmul", a, b)
    _build.refuse_traced("matmul", a, b)
    out_dtype = out_dtype or a.dtype
    if bk < 1:
        raise ValueError(f"block depth bk={bk} must be positive")
    if a.device.type == "cpu":
        return ref.matmul(a, b, out_dtype=out_dtype)
    if a.device.type != "cuda":
        raise ValueError(f"the matmul runs on cpu or cuda, not {a.device}")
    check_inputs(a, b, out_dtype)
    m, k = a.shape
    n = b.shape[1]
    tile = hopper_tile(m, n, bm, bn, a.dtype)
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    with torch.cuda.device(a.device):
        err = _entry()(
            a.data_ptr(), b.data_ptr(), out.data_ptr(), m, n, k,
            _DTYPE_CODES[a.dtype], _DTYPE_CODES[out_dtype], *tile,
            torch.cuda.current_stream(a.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"matmul kernel launch failed (code {err}) for "
                           f"({m}, {k}) @ ({k}, {n}) {a.dtype} -> "
                           f"{out_dtype}, tile {tile}")
    launches += 1
    return out
