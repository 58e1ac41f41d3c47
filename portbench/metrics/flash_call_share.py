"""The share of attention layer calls that the flash kernel served: its
launch counter over the attention layers of the requests in the traced
window.  The rest took the plain path (``models/attention.py``'s
dispatch sends only lengths that are a multiple of 128 to the kernel)."""
from portbench import counts


def read(t):
    layers = sum(k in ("attn", "local_attn")
                 for k in counts.block_kinds(t.model))
    calls = layers * len(t.prompts)
    if not calls:
        return None
    flash = sum(p["launches"].get("flash_attention", 0) for p in t.prompts)
    return 100.0 * flash / calls
