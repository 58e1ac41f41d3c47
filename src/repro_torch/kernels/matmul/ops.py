"""Public matmul op with block-size selection hooks: the plain version for
products with a dimension under 8, else the kernel (its plain version on CPU
tensors).  Counterpart of ``repro/kernels/matmul/ops.py``.

``predict_block_time`` prices a candidate (bm, bn, bk) with the core
analytical model and ``select_blocks`` returns the argmin: the paper's
adaptive tile selection (§IV-B), applied to the Hopper kernel's
instantiated output tiles.  The reference prices TPU BlockSpecs against
``TPU_V5E``; here each tile is a ``TileConfig`` of ``gemm_workload`` priced
through ``core.autotune`` on an H100 parameter file, which routes to the
``stage`` model (fractional waves over the card's 132 SMs).  As in the
reference, ``matmul`` itself does not call them."""
from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ...core import autotune, hardware
from ...core.hardware import HardwareParams
from ...core.workload import TileConfig, gemm_workload
from . import kernel, ref

_PRECISION_DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}

Blocks = Tuple[int, int, int]


def matmul(a, b, *, bm: int = kernel.DEFAULT_BM, bn: int = kernel.DEFAULT_BN,
           bk: int = kernel.DEFAULT_BK, out_dtype=None):
    m, k = a.shape
    n = b.shape[1]
    if min(m, n, k) < 8:
        return ref.matmul(a, b, out_dtype=out_dtype)
    return kernel.matmul_tiled(a, b, bm=bm, bn=bn, bk=bk, out_dtype=out_dtype)


def kernel_blocks(precision: str = "bf16") -> Tuple[Blocks, ...]:
    """The kernel's instantiated tiles for ``precision`` inputs ("fp32" or
    "bf16") as (bm, bn, bk) candidates."""
    if precision not in _PRECISION_DTYPES:
        raise ValueError(f"the kernel takes {sorted(_PRECISION_DTYPES)} "
                         f"inputs, not {precision!r}")
    return tuple((bm, bn, kernel.BK)
                 for bm, bn in kernel.TILES[_PRECISION_DTYPES[precision]])


def select_blocks(m: int, n: int, k: int, *,
                  candidates: Optional[Sequence[Blocks]] = None,
                  precision: str = "bf16",
                  hw: Optional[HardwareParams] = None
                  ) -> Tuple[Blocks, Dict[Blocks, float]]:
    """Model-driven argmin over (bm, bn, bk) candidates, by default the
    kernel's instantiated tiles for ``precision``: ``(best, costs)``, with
    ``costs`` in seconds keyed by (bm, bn, bk), one columnar sweep through
    ``autotune.select_tile``.

    ``hw`` defaults to the datasheet ``h100`` file, as the reference's
    default is its own chip's.  A measured file prices fp32 only:
    ``calibrate_device`` measures no bf16 matrix rate, and its update
    replaces the whole ``tensor_sustained_flops`` table, so bf16 on
    ``h100_measured`` would fall back to a rate scaled from fp32's.  Price
    bf16 with the datasheet file and fp32 with the measured one."""
    if candidates is None:
        candidates = kernel_blocks(precision)
    hw = hw or hardware.get("h100")
    tiles = [TileConfig(bm, bn, bk) for bm, bn, bk in candidates]
    base = gemm_workload(f"matmul_{m}x{n}x{k}", m, n, k, precision=precision)
    best, costs = autotune.select_tile(base, hw, tiles)
    return ((best.bm, best.bn, best.bk),
            {(t.bm, t.bn, t.bk): costs[f"{t.bm}x{t.bn}x{t.bk}"]
             for t in tiles})


def predict_block_time(m: int, n: int, k: int, blocks: Blocks,
                       precision: str = "bf16",
                       hw: Optional[HardwareParams] = None) -> float:
    """Model time in seconds of the (m, k) @ (k, n) product run with one
    (bm, bn, bk) tile; ``hw`` as in ``select_blocks``."""
    _, costs = select_blocks(m, n, k, candidates=(tuple(blocks),),
                             precision=precision, hw=hw)
    return costs[tuple(blocks)]
