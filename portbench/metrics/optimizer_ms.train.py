"""Device milliseconds a training step of its optimizer phase: the
compute spans ``optimizer`` (``train/train_step.py``: the global-norm clip
and the AdamW update over every leaf) of the traced steps, between CUDA
events on the stream, over the number of steps."""
from portbench import spans


def read(t):
    got = spans.traced(t, "train_step")
    if got is None:
        return None
    roots, traced = got
    secs = [s.device_s for s in traced if s.name == "optimizer"]
    if not secs:
        return None
    return 1e3 * sum(secs) / len(roots)
