from .adamw import adamw_init, adamw_update, clip_by_global_norm  # noqa
from .schedule import cosine_schedule, linear_schedule, wsd_schedule  # noqa
from .grad_compression import (compress_int8, decompress_int8,  # noqa
                               error_feedback_update)
