"""Device microseconds a prompt token of the Mamba2 mixer: the compute
spans ``ssm`` (``ssm_apply`` in ``models/blocks.py``: the input products,
the causal convolutions, the SSD scan, the gated norm and the output
product) of the traced requests, between CUDA events on the stream, over
their tokens."""
from portbench import spans


def read(t):
    return spans.device_us_per_token(t, "ssm")
