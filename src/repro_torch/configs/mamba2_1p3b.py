"""mamba2-1.3b [ssm] — SSD (state-space duality), attn-free.
48L d_model=2048 d_ff=0 vocab=50280 ssm_state=128 [arXiv:2405.21060].
d_inner = 2*d_model = 4096, headdim 64 -> 64 SSD heads.  Sub-quadratic:
runs the long_500k cell."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    n_layers=48,
    d_model=2048,
    n_heads=0,
    n_kv_heads=0,
    d_ff=0,
    vocab=50280,
    pattern=("ssm",),
    ssm_state=128,
    ssm_headdim=64,
    ssm_expand=2,
    ssm_chunk=256,
    conv_width=4,
    tie_embeddings=True,
    dtype="bfloat16",
    param_dtype="bfloat16",
    remat="block",
)

SMOKE = CONFIG.replace(
    name="mamba2-smoke",
    n_layers=2,
    d_model=64,
    vocab=128,
    ssm_state=16,
    ssm_headdim=16,
    ssm_chunk=16,
    dtype="float32",
    param_dtype="float32",
    remat="none",
)
