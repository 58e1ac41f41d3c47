"""The SSD kernel's share of its roofline: the least time its calls could
take (the scan's work at the published chunk over the bf16 peak, or its
fp32 inputs and output moved once over HBM's rate, whichever is larger)
over the device time of its three passes in the traced window."""
from portbench import counts

KERNELS = ("chunk_state", "state_passing", "chunk_scan")


def read(t):
    secs = sum(t.kernel_seconds(k) for k in KERNELS)
    if secs <= 0:
        return None
    m = t.model
    di = m.get("ssm_expand", 2) * m["d_model"]
    p_dim = m.get("ssm_headdim", 64)
    bound = sum(
        p["launches"].get("ssd", 0) * counts.bound_s(*counts.ssd_work(
            1, p["len"], di // p_dim, p_dim, m["ssm_state"]))
        for p in t.prompts)
    if bound <= 0:
        return None
    return 100.0 * bound / secs
