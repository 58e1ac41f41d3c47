from .ops import ssd_scan  # noqa: F401
from . import kernel, ref  # noqa: F401
