"""Model configuration schema.

The port's own copy of the JAX package's ``configs/base.py``, kept field for
field so a config means the same model in both packages (the port imports
nothing of the JAX package).

One dataclass covers all 10 assigned architecture families; family-specific
fields default to "unused".  Every ``src/repro_torch/configs/<arch>.py``
exports ``CONFIG`` (the exact assigned full-scale config) and ``SMOKE`` (a
reduced same-family config for CPU smoke tests).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | audio | vlm

    # --- core dims ----------------------------------------------------------
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 -> d_model // n_heads
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    tie_embeddings: bool = False

    # --- attention variant --------------------------------------------------
    window: int = 0                # >0: sliding-window attention (SWA)
    attn_logit_softcap: float = 0.0

    # --- block pattern (hybrid / vlm) ----------------------------------------
    # sequence of block kinds repeated to fill n_layers, e.g.
    # ("rglru", "rglru", "local_attn") or ("attn",)*4 + ("cross_attn",)
    pattern: Tuple[str, ...] = ("attn",)

    # --- MoE -----------------------------------------------------------------
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    d_expert: int = 0              # expert FFN width (d_ff used if 0)
    capacity_factor: float = 1.25
    router_aux_coef: float = 0.001
    moe_every: int = 1             # MoE layer every k-th block (1 = all)
    first_dense: int = 0           # leading dense blocks before MoE starts

    # --- MLA (deepseek-v3) ---------------------------------------------------
    use_mla: bool = False
    kv_lora_rank: int = 512
    q_lora_rank: int = 0           # 0 -> no q compression
    rope_head_dim: int = 64

    # --- MTP (deepseek-v3 multi-token prediction) ----------------------------
    mtp_depth: int = 0

    # --- SSM (mamba2) --------------------------------------------------------
    ssm_state: int = 0             # N
    ssm_headdim: int = 64          # P
    ssm_expand: int = 2            # d_inner = expand * d_model
    ssm_chunk: int = 128
    conv_width: int = 4

    # --- RG-LRU (recurrentgemma) ---------------------------------------------
    lru_width: int = 0             # 0 -> d_model

    # --- encoder-decoder (whisper) -------------------------------------------
    enc_layers: int = 0            # 0 -> decoder-only
    enc_seq_ratio: float = 1.0     # encoder len = ratio * seq_len

    # --- modality frontends (STUBS per assignment) ---------------------------
    n_image_tokens: int = 0        # vlm: stub patch-embedding count
    frontend_dim: int = 0          # stub embedding dim (0 -> d_model)

    # --- numerics / training -------------------------------------------------
    dtype: str = "float32"         # activation/compute dtype
    param_dtype: str = "float32"
    remat: str = "none"            # none | block | full
    scan_layers: bool = True
    residual_scale: float = 1.0    # minicpm-style depth scaling
    logit_scale: float = 1.0
    use_flash_kernel: bool = False  # hand-written CUDA kernel on the card;
                                    # its plain version on CPU tensors
    attn_chunk: int = 0            # >0: chunked (flash-in-XLA) attention
    attn_chunk_unroll: bool = False  # unroll the chunk loop (dry-run
                                     # accounting: while-bodies are counted
                                     # once by cost_analysis)
    # --- §Perf hillclimb switches (off = paper-faithful baseline) ---------
    ssd_shard_map: bool = False    # explicit shard_map SSD layer (kills the
                                   # GSPMD bwd all-reduces; EXPERIMENTS §Perf)
    ssd_tile_bf16: bool = False    # bf16 (L,L) SSD tiles, fp32 accumulation
    mtp_share_trunk: bool = False  # MTP head reuses the main forward's
                                   # hidden states instead of re-running it

    def __post_init__(self):
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim",
                               self.d_model // max(self.n_heads, 1))
        if self.n_heads and self.n_heads % max(self.n_kv_heads, 1) != 0:
            raise ValueError("n_heads must be divisible by n_kv_heads")
        if (self.n_layers - self.first_dense) % len(self.pattern) != 0:
            raise ValueError(
                f"n_layers={self.n_layers} minus first_dense="
                f"{self.first_dense} not divisible by pattern "
                f"{self.pattern}")

    # --- derived -------------------------------------------------------------
    @property
    def n_groups(self) -> int:
        return (self.n_layers - self.first_dense) // len(self.pattern)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_headdim

    @property
    def expert_ff(self) -> int:
        return self.d_expert or self.d_ff

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)

    # --- analytics (feeds MODEL_FLOPS = 6*N*D in §Roofline) -------------------
    def param_count(self) -> int:
        """Total parameters (embeddings included)."""
        return _count_params(self)

    def active_param_count(self) -> int:
        """Parameters touched per token (MoE: top_k + shared only)."""
        return _count_params(self, active_only=True)


def _attn_params(cfg: ModelConfig, kind: str) -> int:
    d, hd = cfg.d_model, cfg.head_dim
    if kind == "mla":
        qd = hd + cfg.rope_head_dim
        q = d * cfg.n_heads * qd if cfg.q_lora_rank == 0 else \
            d * cfg.q_lora_rank + cfg.q_lora_rank * cfg.n_heads * qd
        kv = d * (cfg.kv_lora_rank + cfg.rope_head_dim) \
            + cfg.kv_lora_rank * cfg.n_heads * (hd + hd)
        o = cfg.n_heads * hd * d
        return q + kv + o
    q = d * cfg.n_heads * hd
    kv = 2 * d * cfg.n_kv_heads * hd
    o = cfg.n_heads * hd * d
    return q + kv + o


def _mlp_params(cfg: ModelConfig, width: int) -> int:
    return 3 * cfg.d_model * width          # SwiGLU: gate, up, down


def _moe_params(cfg: ModelConfig, active_only: bool) -> int:
    router = cfg.d_model * cfg.n_experts
    n_routed = cfg.top_k if active_only else cfg.n_experts
    routed = n_routed * _mlp_params(cfg, cfg.expert_ff)
    shared = cfg.n_shared_experts * _mlp_params(cfg, cfg.expert_ff)
    return router + routed + shared


def _ssm_params(cfg: ModelConfig) -> int:
    d, di, n, h = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_ch = di + 2 * n
    in_proj = d * (2 * di + 2 * n + h)      # z, x, B, C, dt
    conv = cfg.conv_width * conv_ch + conv_ch
    out_proj = di * d
    extras = 3 * h + di                     # A_log, dt_bias, D skip, norm
    return in_proj + conv + out_proj + extras


def _rglru_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    w = cfg.lru_width or d
    # wx, wy, w_out + conv(4w + w) + block-diag gates 2*(w^2/8) + b_gates 2w
    # + lambda w
    return 3 * d * w + 5 * w + 2 * w * w // 8 + 3 * w


def _block_params(cfg: ModelConfig, kind: str, active_only: bool) -> int:
    norms = 2 * cfg.d_model
    if kind in ("attn", "local_attn"):
        body = _attn_params(cfg, "gqa") + \
            (_mlp_params(cfg, cfg.d_ff) if cfg.d_ff else 0)
        if not cfg.d_ff:
            norms = cfg.d_model
    elif kind == "cross_attn":
        # self-attn + gated cross-attn + mlp, 3 norms + gate scalar
        body = 2 * _attn_params(cfg, "gqa") + _mlp_params(cfg, cfg.d_ff) + 1
        norms = 3 * cfg.d_model
    elif kind == "moe":
        body = _attn_params(cfg, "mla" if cfg.use_mla else "gqa") \
            + _moe_params(cfg, active_only)
    elif kind == "ssm":
        body = _ssm_params(cfg)
        norms = cfg.d_model
    elif kind == "rglru":
        body = _rglru_params(cfg) + \
            (_mlp_params(cfg, cfg.d_ff) if cfg.d_ff else 0)
    else:
        raise ValueError(kind)
    return body + norms


def _count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    total = cfg.vocab * cfg.d_model         # embed
    if not cfg.tie_embeddings:
        total += cfg.vocab * cfg.d_model    # lm head
    total += cfg.d_model                    # final norm
    per_group = sum(_block_params(cfg, k, active_only) for k in cfg.pattern)
    total += cfg.n_groups * per_group
    total += cfg.first_dense * _block_params(cfg, "attn", active_only)
    if cfg.enc_layers:
        # encoder stack (attn blocks) + encoder final norm
        total += cfg.enc_layers * _block_params(cfg, "attn", active_only)
        total += cfg.d_model
    if cfg.mtp_depth > 0:
        total += 2 * cfg.d_model * cfg.d_model          # fusion proj
        total += _block_params(cfg, "attn", active_only)
        total += 2 * cfg.d_model                        # two norms
    return total
