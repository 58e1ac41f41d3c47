"""whisper-tiny [audio] — enc-dec transformer backbone; conv audio frontend
is a STUB (input_specs provides precomputed frame embeddings).
4L d_model=384 6H (kv=6) d_ff=1536 vocab=51865 [arXiv:2212.04356].

Shape mapping (DESIGN.md §4): encoder length = seq_len, decoder length =
seq_len (teacher forcing) for train; decode attends cross to the
seq_len-frame encoder output with a self KV cache."""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-tiny",
    family="audio",
    n_layers=4,                # decoder layers
    enc_layers=4,              # encoder layers
    d_model=384,
    n_heads=6,
    n_kv_heads=6,
    d_ff=1536,
    vocab=51865,
    pattern=("cross_attn",),
    tie_embeddings=True,
    dtype="bfloat16",
    param_dtype="bfloat16",
    remat="block",
    attn_chunk=1024,
)

SMOKE = CONFIG.replace(
    name="whisper-smoke",
    n_layers=2,
    enc_layers=2,
    d_model=64,
    n_heads=4,
    n_kv_heads=4,
    d_ff=128,
    vocab=128,
    dtype="float32",
    param_dtype="float32",
    attn_chunk=0,
)
