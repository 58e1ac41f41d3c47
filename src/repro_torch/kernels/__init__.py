"""Hand-written Hopper kernels of the port, one subpackage per TPU kernel of
the JAX package, each in the same three layers:

  * kernel.py — ctypes wrapper of the CUDA source in ``csrc/`` (built by
                ``_build`` at first use); plain version for CPU tensors
  * ops.py    — public op with the reference's dispatch rules
  * ref.py    — plain PyTorch version, the oracle the kernel is held against

All four are ported: flash_attention (dense attention prefill), ssd (the
Mamba2 SSD scan), matmul and rmsnorm (measured workloads of the validation
suite, ``core.microbench.device_suite``).
"""
from . import flash_attention  # noqa: F401
from . import matmul  # noqa: F401
from . import rmsnorm  # noqa: F401
from . import ssd  # noqa: F401
