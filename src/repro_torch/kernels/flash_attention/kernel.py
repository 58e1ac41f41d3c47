"""Wrapper of the hand-written Hopper flash-attention kernel
(``csrc/flash_attention.cu``), the port of the TPU kernel
``repro/kernels/flash_attention/kernel.py:mha``.

CPU tensors take the plain version (``ref.attention``).  CUDA tensors launch
the kernel or raise; nothing falls back.  The kernel library is built with
nvcc and loaded with ctypes at the first CUDA call, never at import.
"""
from __future__ import annotations

import ctypes

import torch

from .. import _build
from . import ref

HEAD_DIMS = (64, 80, 128, 256)     # head dims the kernel is instantiated for
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535               # heads and batch ride grid.y and grid.z

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 9
             + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])

# Kernel launches; the wrapper adds one per launch and nowhere else.  A
# caller resets it to 0 before the run it wants to count.
launches = 0


def check_inputs(q, k, v) -> None:
    """Raise on anything the CUDA kernel does not take."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-D (B, H, S, D), got "
                             f"{tuple(t.shape)}")
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name} has dtype {t.dtype}; the kernel takes "
                            f"{sorted(map(str, _DTYPE_CODES))}")
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("q, k and v must share dtype and device")
        if t.stride(-1) != 1:
            raise ValueError(f"{name} must have a contiguous head dim "
                             f"(stride {t.stride(-1)})")
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if tuple(k.shape) != (b, hkv, s, d) or tuple(v.shape) != tuple(k.shape):
        raise ValueError(f"k and v must be (B, Hkv, S, D) = "
                         f"{(b, hkv, s, d)}; got {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if hkv == 0 or hq % hkv != 0:
        raise ValueError(f"q heads {hq} not a multiple of kv heads {hkv}")
    if d not in HEAD_DIMS:
        raise ValueError(f"head dim {d} has no kernel instantiation; "
                         f"instantiated: {HEAD_DIMS}")
    if s == 0 or b == 0 or hq == 0:
        raise ValueError(f"empty attention input {tuple(q.shape)}")
    if b > _MAX_GRID_YZ or hq > _MAX_GRID_YZ:
        raise ValueError(f"batch {b} or heads {hq} above {_MAX_GRID_YZ}")


def _entry():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def mha(q, k, v, *, sm_scale: float, causal: bool = True, window: int = 0):
    """q: (B, Hq, S, D); k, v: (B, Hkv, S, D); Hq % Hkv == 0.

    window > 0 keeps keys with q_pos - window <= k_pos (on top of causal).
    Returns a contiguous (B, Hq, S, D) tensor in q's dtype.

    On the card, bf16 inputs run on the tensor cores (mma.sync, scores and
    softmax in fp32, P split into bf16 p_hi + p_lo for the product with V);
    fp32 inputs run in fp32 on the CUDA cores."""
    global launches
    if q.device.type == "cpu":
        return ref.attention(q, k, v, sm_scale=sm_scale, causal=causal,
                             window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, not "
                         f"{q.device}")
    check_inputs(q, k, v)
    b, hq, s, d = q.shape
    out = torch.empty((b, hq, s, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = _entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], b, hq, k.shape[1], s, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(sm_scale), int(causal), int(window),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed "
                           f"(code {err}) for q {tuple(q.shape)} {q.dtype}")
    launches += 1
    return out
