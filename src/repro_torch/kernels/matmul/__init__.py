from .ops import matmul  # noqa: F401
from . import kernel, ref  # noqa: F401
