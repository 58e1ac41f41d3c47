from .base import ModelConfig  # noqa: F401
from .registry import (ARCH_IDS, SHAPES, SUBQUADRATIC, all_cells,  # noqa
                       cell_applicable, get_config, memory_len)
