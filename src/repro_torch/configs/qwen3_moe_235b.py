"""qwen3-moe-235b-a22b [moe] — 128 experts top-8, GQA kv=4.
94L d_model=4096 64H d_ff=1536(expert) vocab=151936
[hf:Qwen/Qwen3-30B-A3B scaled family]."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="qwen3-moe-235b-a22b",
    family="moe",
    n_layers=94,
    d_model=4096,
    n_heads=64,
    n_kv_heads=4,
    d_ff=1536,
    vocab=151936,
    head_dim=128,
    pattern=("moe",),
    n_experts=128,
    top_k=8,
    n_shared_experts=0,
    d_expert=1536,
    capacity_factor=1.25,
    rope_theta=1000000.0,
    dtype="bfloat16",
    param_dtype="bfloat16",
    remat="full",
    attn_chunk=1024,
)

SMOKE = CONFIG.replace(
    name="qwen3moe-smoke",
    n_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=2,
    head_dim=16,
    d_ff=48,
    d_expert=48,
    vocab=128,
    n_experts=8,
    top_k=2,
    capacity_factor=4.0,
    dtype="float32",
    param_dtype="float32",
    remat="none",
    attn_chunk=0,
)
