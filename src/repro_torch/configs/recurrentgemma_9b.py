"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2:1 pattern.
38L d_model=4096 16H (MQA kv=1) d_ff=12288 vocab=256000
[arXiv:2402.19427].  Local attention window 2048.

38 layers = 2 groups x 19-block pattern ((rglru, rglru, local_attn) x 6 +
one trailing rglru) — matches the published 2:1 mix with a recurrent tail.
Sub-quadratic: runs long_500k."""
from .base import ModelConfig

_PATTERN = ("rglru", "rglru", "local_attn") * 6 + ("rglru",)

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    n_layers=38,
    d_model=4096,
    n_heads=16,
    n_kv_heads=1,
    d_ff=12288,
    vocab=256000,
    head_dim=256,
    window=2048,
    pattern=_PATTERN,
    lru_width=4096,
    tie_embeddings=True,
    attn_logit_softcap=30.0,
    dtype="bfloat16",
    param_dtype="bfloat16",
    remat="block",
    attn_chunk=1024,
)

SMOKE = CONFIG.replace(
    name="rg-smoke",
    n_layers=3,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    head_dim=16,
    d_ff=128,
    vocab=128,
    window=8,
    pattern=("rglru", "rglru", "local_attn"),
    lru_width=64,
    dtype="float32",
    param_dtype="float32",
    remat="none",
    attn_chunk=0,
)
