"""Device microseconds a prompt token of the blocks' RMS norms: the
compute spans ``norm`` (``ln1`` and ``ln2`` in ``models/blocks.py``) of
the traced requests, between CUDA events on the stream, over their
tokens.  The final norm before the head is the root's own time."""
from portbench import spans


def read(t):
    return spans.device_us_per_token(t, "norm")
