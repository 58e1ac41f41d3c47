"""minicpm-2b [dense] — WSD schedule, llama-like arch with depth/width
mup-style scaling.  40L d_model=2304 36H (kv=36 = MHA) d_ff=5760
vocab=122753 [arXiv:2404.06395].  Tied embeddings; residual scaled by
1.4/sqrt(L); logits scaled by 256/d_model.  The WSD (warmup-stable-decay)
schedule is wired in repro.optim.schedule and selected by the train
driver for this arch."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="minicpm-2b",
    family="dense",
    n_layers=40,
    d_model=2304,
    n_heads=36,
    n_kv_heads=36,
    d_ff=5760,
    vocab=122753,
    tie_embeddings=True,
    residual_scale=1.4 / 40 ** 0.5,
    logit_scale=256.0 / 2304.0,
    dtype="bfloat16",
    param_dtype="bfloat16",
    remat="block",
    attn_chunk=1024,
)

SMOKE = CONFIG.replace(
    name="minicpm-smoke",
    n_layers=2,
    d_model=72,
    n_heads=6,
    n_kv_heads=6,
    d_ff=180,
    vocab=128,
    residual_scale=1.4 / 2 ** 0.5,
    logit_scale=256.0 / 72.0,
    dtype="float32",
    param_dtype="float32",
    remat="none",
    attn_chunk=0,
)
