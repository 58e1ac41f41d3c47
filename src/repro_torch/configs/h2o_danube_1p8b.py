"""h2o-danube-1.8b [dense] — llama+mistral mix with sliding-window attention.
24L d_model=2560 32H (GQA kv=8) d_ff=6912 vocab=32000 [arXiv:2401.16818].
SWA window 4096 (mistral-style) -> sub-quadratic, runs long_500k."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="h2o-danube-1.8b",
    family="dense",
    n_layers=24,
    d_model=2560,
    n_heads=32,
    n_kv_heads=8,
    d_ff=6912,
    vocab=32000,
    window=4096,
    pattern=("local_attn",),
    rope_theta=10000.0,
    dtype="bfloat16",
    param_dtype="bfloat16",
    remat="block",
    attn_chunk=1024,
)

SMOKE = CONFIG.replace(
    name="danube-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=1,
    d_ff=160,
    vocab=128,
    window=8,
    dtype="float32",
    param_dtype="float32",
    remat="none",
    attn_chunk=0,
)
