"""Public matmul op with the reference's dispatch: the plain version for
products with a dimension under 8, else the kernel (its plain version on
CPU tensors).  Counterpart of ``repro/kernels/matmul/ops.py:matmul``.

The reference's ``predict_block_time`` / ``select_blocks`` price TPU
BlockSpecs against ``TPU_V5E`` and are not ported: Hopper tile selection
over this kernel's instantiated tiles is ROADMAP.md Queue A item 2."""
from __future__ import annotations

from . import kernel, ref


def matmul(a, b, *, bm: int = kernel.DEFAULT_BM, bn: int = kernel.DEFAULT_BN,
           bk: int = kernel.DEFAULT_BK, out_dtype=None):
    m, k = a.shape
    n = b.shape[1]
    if min(m, n, k) < 8:
        return ref.matmul(a, b, out_dtype=out_dtype)
    return kernel.matmul_tiled(a, b, bm=bm, bn=bn, bk=bk, out_dtype=out_dtype)
