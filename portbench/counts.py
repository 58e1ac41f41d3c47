"""The work a cell needs and the card's published peaks.

Every count here is of the work the inputs need, whatever implements it:
the same number for the flash kernel, the plain path or a later kernel with
other tiles, and for the SSD kernel whatever arithmetic it runs in.  A
share of a peak is priced at one published rate of one NVIDIA H100 SXM
(data sheet, dense, no sparsity): bf16 989e12 FLOP/s and HBM 3.35e12 B/s.
No share is priced at the rate of one implementation's arithmetic.

A model is described by the dict under ``"model"`` in its configuration
file (``portbench/configs/<config>.json``), with the port's field names.
The whole-model counts here (``prefill_flops``, ``train_flops``,
``attention_layers``, ``attention_calls``) are the defaults: a
configuration's own reference module (``references/<config>.py``) may give
its own, and the readers that price a whole model take the cell's from the
trace (``t.counts``).
"""
from __future__ import annotations

PEAK_BF16_FLOPS = 989e12        # FLOP/s, dense bf16 tensor cores
PEAK_HBM_BYTES = 3.35e12        # B/s
SSD_CHUNK = 256                 # mamba2's published ssm_chunk


def head_dim(m: dict) -> int:
    return m.get("head_dim") or m["d_model"] // max(m["n_heads"], 1)


def live_pairs(s: int, causal: bool, window: int) -> int:
    """(query, key) pairs the causal and window masks leave, in closed
    form: query q sees keys max(0, q - window) .. q."""
    if not causal:
        return s * s
    if window <= 0 or window >= s - 1:
        return s * (s + 1) // 2
    full = window + 1                     # keys of a query past the ramp
    ramp = full * (full + 1) // 2         # queries 0 .. window
    return ramp + (s - full) * full


def attention_flops(b: int, hq: int, s: int, d: int, causal: bool,
                    window: int) -> float:
    """Forward: Q K^T and P V, two multiply-adds per live pair and dim."""
    return 4.0 * d * live_pairs(s, causal, window) * b * hq


def attention_bytes(b: int, hq: int, hkv: int, s: int, d: int,
                    itemsize: int = 2) -> float:
    """q and o read / written once, k and v read once."""
    return float(itemsize * (2 * b * hq * s * d + 2 * b * hkv * s * d))


def ssd_work(b: int, s: int, h: int, p: int, n: int,
             chunk: int = SSD_CHUNK):
    """(FLOPs, bytes) of one SSD scan at the published chunk: C B^T on the
    live (j <= i) entries of each chunk once (it does not depend on the
    head), then per head the masked product with x and the state's
    contribution and read-out; x, y, dt, a_log, b, c moved once in fp32."""
    live = chunk * (chunk + 1) // 2
    per_chunk = 2 * live * n + h * (2 * live * p + 4 * chunk * n * p)
    flops = b * (s // chunk) * per_chunk
    nbytes = 4 * (2 * b * s * h * p + b * s * h + h + 2 * b * s * n)
    return float(flops), float(nbytes)


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of the operations
    over the bf16 peak and the bytes over HBM's rate."""
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_HBM_BYTES)


def block_kinds(m: dict) -> list:
    """The kind of every layer, in order: the dense ``prefix`` blocks
    (``attn``), then the groups of ``pattern``."""
    pattern = list(m.get("pattern", ["attn"]))
    first = m.get("first_dense", 0)
    return ["attn"] * first + pattern * ((m["n_layers"] - first)
                                         // len(pattern))


def attention_layers(m: dict) -> int:
    """Attention-layer calls of one request: the layers whose
    self-attention may take the flash kernel."""
    return sum(k in ("attn", "local_attn") for k in block_kinds(m))


def attention_calls(m: dict, s: int) -> list:
    """(FLOPs, bytes) of each flash-kernel call that a B=1 request of ``s``
    tokens makes: one GQA call of the model's heads at the window of its
    ``local_attn`` layers (if it has any) for each of its attention
    layers."""
    kinds = block_kinds(m)
    window = m.get("window", 0) if "local_attn" in kinds else 0
    hq, hkv, d = m["n_heads"], m["n_kv_heads"], head_dim(m)
    call = (attention_flops(1, hq, s, d, True, window),
            attention_bytes(1, hq, hkv, s, d))
    return [call] * attention_layers(m)


def layer_matmul_params(m: dict, kind: str) -> int:
    """Weights of one layer that multiply activations (depthwise conv,
    norms and per-head scalars excluded)."""
    d = m["d_model"]
    if kind in ("attn", "local_attn"):
        hd = head_dim(m)
        attn = d * m["n_heads"] * hd * 2 + d * m["n_kv_heads"] * hd * 2
        return attn + 3 * d * m["d_ff"]
    if kind == "ssm":
        di = m.get("ssm_expand", 2) * d
        n = m["ssm_state"]
        h = di // m.get("ssm_headdim", 64)
        return d * (2 * di + 2 * n + h) + di * d
    raise ValueError(f"no count for block kind {kind!r}")


def matmul_params(m: dict) -> int:
    """Every layer's weight products, the head excluded."""
    return sum(layer_matmul_params(m, k) for k in block_kinds(m))


def mixer_flops(m: dict, s: int, b: int = 1) -> float:
    """Forward work of the sequence mixers over a (b, s) batch: attention
    over the live pairs, the SSD scan at the published chunk."""
    total = 0.0
    for kind in block_kinds(m):
        if kind in ("attn", "local_attn"):
            window = m.get("window", 0) if kind == "local_attn" else 0
            total += attention_flops(b, m["n_heads"], s, head_dim(m), True,
                                     window)
        elif kind == "ssm":
            di = m.get("ssm_expand", 2) * m["d_model"]
            p = m.get("ssm_headdim", 64)
            total += ssd_work(b, s, di // p, p, m["ssm_state"])[0]
    return total


def prefill_flops(m: dict, s: int) -> float:
    """One B=1 request of ``s`` prompt tokens: the weight products at
    every position, the head at the last one, the mixers."""
    return (2.0 * matmul_params(m) * s + 2.0 * m["d_model"] * m["vocab"]
            + mixer_flops(m, s))


def train_flops(m: dict, b: int, s: int) -> float:
    """One training step of (b, s) tokens: 6 x (weights that multiply,
    the head included) x tokens, and three times the mixers' forward work
    (forward and backward; recompute not counted)."""
    weights = matmul_params(m) + m["d_model"] * m["vocab"]
    return 6.0 * weights * b * s + 3.0 * mixer_flops(m, s, b)
