from .ops import flash_attention  # noqa: F401
from . import kernel, ref  # noqa: F401
