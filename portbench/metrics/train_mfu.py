"""The whole training step's share of the card's bf16 peak: 6 x weights x
tokens and three times attention's forward work on the live pairs
(``portbench.counts.train_flops``) of the steps in the traced window, over
its seconds."""
from portbench import counts


def read(t):
    if not t.steps or t.window_s <= 0:
        return None
    flops = t.steps * counts.train_flops(t.model, t.batch, t.seq)
    return 100.0 * flops / t.window_s / counts.PEAK_BF16_FLOPS
