from .ops import rmsnorm  # noqa: F401
from . import kernel, ref  # noqa: F401
