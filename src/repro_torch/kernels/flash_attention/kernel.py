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

HEAD_DIMS = (16, 64, 80, 128, 256)  # head dims the kernel is instantiated for
# bf16 head dims that take the wgmma + TMA kernel (``attn_fwd_wg``), each
# faster there than on mma.sync on the card; 16 and 256 stay on mma.sync
# (``attn_fwd_tc``: at 256 a 64-row fp32 O alone is 128 registers a
# thread), fp32 on ``attn_fwd_f32``.
WGMMA_HEAD_DIMS = (64, 80, 128)
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_MAX_GRID_YZ = 65535               # heads and batch ride grid.y and grid.z

_ARGTYPES = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
             + [ctypes.c_longlong] * 9
             + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])

# Kernel launches; the wrapper adds one per launch and nowhere else.  A
# caller resets it to 0 before the run it wants to count.
launches = 0
# The launches among them that took the wgmma + TMA kernel.
wgmma_launches = 0


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


def padded_head_dim(d: int) -> int:
    """The instantiated head dim a head dim ``d`` runs at: ``d`` itself, or
    the next one up.  Raises above 256, which the reference's kernel cannot
    tile either."""
    for inst in HEAD_DIMS:
        if d <= inst:
            return inst
    raise ValueError(f"head dim {d} has no kernel instantiation; the kernel "
                     f"takes head dims up to {HEAD_DIMS[-1]}")


def pad_head_dim(q, k, v):
    """q, k and v zero-padded along the head dim to ``padded_head_dim``
    (returned as they are when it is instantiated)."""
    pad = padded_head_dim(q.shape[-1]) - q.shape[-1]
    if pad == 0:
        return q, k, v
    return tuple(torch.nn.functional.pad(t, (0, pad)) for t in (q, k, v))


def tma_aligned(*tensors) -> bool:
    """Whether TMA can describe each tensor as it is: a base and every
    stride but the head dim's a positive multiple of 16 bytes."""
    return all(t.data_ptr() % 16 == 0
               and all(st > 0 and st * t.element_size() % 16 == 0
                       for st in t.stride()[:3])
               for t in tensors)


def select_design(dtype: torch.dtype, head_dim: int, aligned: bool) -> str:
    """The kernel a launch takes, by what the wrapper can observe: "wgmma"
    (bf16 at a head dim of ``WGMMA_HEAD_DIMS`` that TMA can describe),
    "mma.sync" (any other bf16) or "fp32"."""
    if dtype == torch.float32:
        return "fp32"
    if head_dim in WGMMA_HEAD_DIMS and aligned:
        return "wgmma"
    return "mma.sync"


def _entry():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = _ARGTYPES
    fn.restype = ctypes.c_int
    return fn


def mha(q, k, v, *, sm_scale: float, causal: bool = True, window: int = 0):
    """q: (B, Hq, S, D); k, v: (B, Hkv, S, D); Hq % Hkv == 0.

    window > 0 keeps keys with q_pos - window <= k_pos (on top of causal).
    Returns a contiguous (B, Hq, S, D) tensor in q's dtype.

    On the card, bf16 inputs run on the tensor cores (scores and softmax in
    fp32, P split into bf16 p_hi + p_lo for the product with V): through
    wgmma fed by TMA where ``select_design`` says so, else mma.sync; fp32
    inputs run in fp32 on the CUDA cores.

    A head dim ``d <= 256`` that is not in ``HEAD_DIMS`` (40, 96, ...) is
    zero-padded to the next instantiated one (``pad_head_dim``): zero
    columns add nothing to Q·Kᵀ, ``sm_scale`` is passed as given, and the
    output's zero columns are sliced off.  Still one kernel launch; the pad
    costs a padded copy of q, k and v and of the output, and the kernel
    does the work of the padded width (d = 40 runs at 64: 1.6x)."""
    global launches, wgmma_launches
    _build.refuse_autograd("flash attention", q, k, v)
    _build.refuse_traced("flash attention", q, k, v)
    if q.device.type == "cpu":
        return ref.attention(q, k, v, sm_scale=sm_scale, causal=causal,
                             window=window)
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cpu or cuda, not "
                         f"{q.device}")
    d_in = q.shape[-1]
    q, k, v = pad_head_dim(q, k, v)
    check_inputs(q, k, v)
    b, hq, s, d = q.shape
    wgmma = select_design(q.dtype, d, tma_aligned(q, k, v)) == "wgmma"
    out = torch.empty((b, hq, s, d), dtype=q.dtype, device=q.device)
    with torch.cuda.device(q.device):
        err = _entry()(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            _DTYPE_CODES[q.dtype], b, hq, k.shape[1], s, d,
            *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
            float(sm_scale), int(causal), int(window), int(wgmma),
            torch.cuda.current_stream(q.device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed "
                           f"(code {err}) for q {tuple(q.shape)} {q.dtype}")
    launches += 1
    wgmma_launches += wgmma
    return out if d == d_in else out[..., :d_in].contiguous()
