"""Device microseconds a prompt token of attention: the compute spans
``attention`` (``attn_apply`` in ``models/blocks.py``: the q, k, v and
output products, rope, and the flash, chunked or plain core) of the
traced requests, between CUDA events on the stream, over their tokens.
The interval holds any wait of the card on the host inside it."""
from portbench import spans


def read(t):
    return spans.device_us_per_token(t, "attention")
