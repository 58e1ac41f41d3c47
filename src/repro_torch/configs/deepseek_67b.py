"""deepseek-67b [dense] — llama-arch, deep/narrow.
95L d_model=8192 64H (GQA kv=8) d_ff=22016 vocab=102400
[arXiv:2401.02954]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-67b",
    family="dense",
    n_layers=95,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=22016,
    vocab=102400,
    rope_theta=10000.0,
    dtype="bfloat16",
    param_dtype="bfloat16",
    remat="full",
    attn_chunk=1024,
)

SMOKE = CONFIG.replace(
    name="deepseek67b-smoke",
    n_layers=3,
    d_model=64,
    n_heads=8,
    n_kv_heads=1,
    d_ff=192,
    vocab=128,
    dtype="float32",
    param_dtype="float32",
    remat="none",
    attn_chunk=0,
)
