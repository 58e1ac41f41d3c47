"""deepseek-v3-671b [moe] — MLA, 1 shared + 256 routed top-8, MTP.
61L d_model=7168 128H d_ff=2048(expert) vocab=129280 [arXiv:2412.19437].
First 3 layers dense; MLA latent KV (kv_lora 512, rope head 64, q_lora
1536); multi-token-prediction head (depth 1)."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,          # assignment: GQA kv=128 — realized via MLA
    d_ff=2048,
    vocab=129280,
    head_dim=128,
    pattern=("moe",),
    first_dense=3,
    n_experts=256,
    top_k=8,
    n_shared_experts=1,
    d_expert=2048,
    capacity_factor=1.25,
    use_mla=True,
    kv_lora_rank=512,
    q_lora_rank=1536,
    rope_head_dim=64,
    mtp_depth=1,
    dtype="bfloat16",
    param_dtype="bfloat16",
    remat="full",
    attn_chunk=1024,
)

SMOKE = CONFIG.replace(
    name="dsv3-smoke",
    n_layers=3,
    first_dense=1,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    head_dim=16,
    d_ff=64,
    d_expert=64,
    vocab=128,
    n_experts=8,
    top_k=2,
    kv_lora_rank=32,
    q_lora_rank=0,
    rope_head_dim=16,
    capacity_factor=4.0,
    dtype="float32",
    param_dtype="float32",
    remat="none",
    attn_chunk=0,
)
