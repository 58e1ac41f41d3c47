"""llama3-405b [dense] — GQA, 128k vocab.
126L d_model=16384 128H (GQA kv=8) d_ff=53248 vocab=128256
[arXiv:2407.21783]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama3-405b",
    family="dense",
    n_layers=126,
    d_model=16384,
    n_heads=128,
    n_kv_heads=8,
    d_ff=53248,
    vocab=128256,
    rope_theta=500000.0,
    dtype="bfloat16",
    param_dtype="bfloat16",
    remat="full",
    attn_chunk=1024,
)

SMOKE = CONFIG.replace(
    name="llama405b-smoke",
    n_layers=2,
    d_model=128,
    n_heads=8,
    n_kv_heads=1,
    d_ff=416,
    vocab=128,
    dtype="float32",
    param_dtype="float32",
    remat="none",
    attn_chunk=0,
)
