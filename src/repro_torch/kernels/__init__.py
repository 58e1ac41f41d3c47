"""Hand-written Hopper kernels of the port, one subpackage per TPU kernel of
the JAX package, each in the same three layers:

  * kernel.py — ctypes wrapper of the CUDA source in ``csrc/`` (built by
                ``_build`` at first use); plain version for CPU tensors
  * ops.py    — public op with the reference's dispatch rules
  * ref.py    — plain PyTorch version, the oracle the kernel is held against

Ported: flash_attention (dense attention prefill) and ssd (the Mamba2 SSD
scan).  matmul and rmsnorm are still to be ported (ROADMAP.md, Queue B).
"""
from . import flash_attention  # noqa: F401
from . import ssd  # noqa: F401
