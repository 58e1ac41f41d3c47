"""llama-3.2-vision-90b [vlm] — cross-attn image layers every 5th block;
vision encoder is a STUB (input_specs provides precomputed patch
embeddings).  100L d_model=8192 64H (GQA kv=8) d_ff=28672 vocab=128256
[hf:meta-llama/Llama-3.2-11B-Vision family]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-90b",
    family="vlm",
    n_layers=100,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=28672,
    vocab=128256,
    pattern=("attn", "attn", "attn", "attn", "cross_attn"),
    n_image_tokens=1601,        # one tile of 40x40 patches + cls (stub)
    rope_theta=500000.0,
    dtype="bfloat16",
    param_dtype="bfloat16",
    remat="full",
    attn_chunk=1024,
)

SMOKE = CONFIG.replace(
    name="vlm-smoke",
    n_layers=5,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    d_ff=160,
    vocab=128,
    n_image_tokens=8,
    dtype="float32",
    param_dtype="float32",
    remat="none",
    attn_chunk=0,
)
