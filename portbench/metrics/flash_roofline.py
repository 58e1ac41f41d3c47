"""The flash-attention kernel's share of its roofline: the least time its
calls could take (each call's larger of the operations over the bf16 peak
and its q, k, v, o moved once over HBM's rate) over the device time of its
kernels (``attn_fwd_*``) in the traced window.  The calls a request makes
are the cell's own count, ``t.counts.attention_calls``: ``portbench.counts``'
unless the configuration's reference module gives its own.  Each call is
weighed by the share of the request's calls that the kernel's launch counter
saw (all of them when every attention layer took the kernel)."""
from collections import Counter

from portbench import counts

KERNEL = "attn_fwd_"


def request_bound(t, p) -> float:
    calls = t.counts.attention_calls(t.model, p["len"])
    launches = p["launches"].get("flash_attention", 0)
    # alike calls priced once, times their number: a sum of equal terms
    # would round differently from the product
    return sum(launches * n / len(calls) * counts.bound_s(*call)
               for call, n in Counter(calls).items())


def read(t):
    secs = t.kernel_seconds(KERNEL)
    if secs <= 0:
        return None
    bound = sum(request_bound(t, p) for p in t.prompts)
    if bound <= 0:
        return None
    return 100.0 * bound / secs
