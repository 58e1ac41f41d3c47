"""The flash-attention kernel's share of its roofline: the least time its
calls could take (the larger of the operations over the bf16 peak and q,
k, v, o moved once over HBM's rate, per call at the request's length) over
the device time of its kernels (``attn_fwd_*``) in the traced window."""
from portbench import counts

KERNEL = "attn_fwd_"


def read(t):
    secs = t.kernel_seconds(KERNEL)
    if secs <= 0:
        return None
    m = t.model
    kinds = counts.block_kinds(m)
    window = m.get("window", 0) if "local_attn" in kinds else 0
    hq, hkv, d = m["n_heads"], m["n_kv_heads"], counts.head_dim(m)
    bound = sum(
        p["launches"].get("flash_attention", 0) * counts.bound_s(
            counts.attention_flops(1, hq, p["len"], d, True, window),
            counts.attention_bytes(1, hq, hkv, p["len"], d))
        for p in t.prompts)
    if bound <= 0:
        return None
    return 100.0 * bound / secs
