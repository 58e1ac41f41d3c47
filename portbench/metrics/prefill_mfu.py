"""The whole prefill step's share of the card's bf16 peak: the work of the
requests served in the traced window (weight products at every position,
the head at the last, attention over the live pairs, the SSD scan at the
published chunk) over its seconds.  The work is the cell's own count,
``t.counts.prefill_flops``: ``portbench.counts``' unless the
configuration's reference module gives its own."""
from portbench import counts


def read(t):
    if not t.prompts or t.window_s <= 0:
        return None
    flops = sum(t.counts.prefill_flops(t.model, p["len"])
                for p in t.prompts)
    return 100.0 * flops / t.window_s / counts.PEAK_BF16_FLOPS
