"""The whole training step's share of the card's bf16 peak: 6 x weights x
tokens and three times attention's forward work on the live pairs of the
steps in the traced window, over its seconds.  The work is the cell's own
count, ``t.counts.train_flops``: ``portbench.counts``' unless the
configuration's reference module gives its own."""
from portbench import counts


def read(t):
    if not t.steps or t.window_s <= 0:
        return None
    flops = t.steps * t.counts.train_flops(t.model, t.batch, t.seq)
    return 100.0 * flops / t.window_s / counts.PEAK_BF16_FLOPS
