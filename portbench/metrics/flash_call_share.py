"""The share of attention layer calls that the flash kernel served: its
launch counter over the attention layers of the requests in the traced
window (``t.counts.attention_layers``, the cell's own count).  The rest
took the chunked or plain path (``models/attention.py``'s dispatch sends
a length to the kernel whatever it is, but for a model with an attention
softcap only a multiple of 128)."""


def read(t):
    calls = t.counts.attention_layers(t.model) * len(t.prompts)
    if not calls:
        return None
    flash = sum(p["launches"].get("flash_attention", 0) for p in t.prompts)
    return 100.0 * flash / calls
