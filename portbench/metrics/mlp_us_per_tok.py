"""Device microseconds a prompt token of the SwiGLU MLP: the compute spans
``mlp`` (``mlp_apply`` in ``models/blocks.py``) of the traced requests,
between CUDA events on the stream, over their tokens."""
from portbench import spans


def read(t):
    return spans.device_us_per_token(t, "mlp")
