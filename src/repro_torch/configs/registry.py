"""Architecture registry + assigned input shapes (the 10 x 4 = 40 cells).

Shapes (assignment):
    train_4k     seq 4,096   global_batch 256   lowers train_step
    prefill_32k  seq 32,768  global_batch 32    lowers prefill (fwd logits)
    decode_32k   seq 32,768  global_batch 128   lowers serve_step (1 token,
                                                KV cache of seq_len)
    long_500k    seq 524,288 global_batch 1     lowers serve_step; ONLY for
                                                sub-quadratic archs

Skip rules (DESIGN.md §4): long_500k runs for mamba2-1.3b, h2o-danube-1.8b,
recurrentgemma-9b (SSM / SWA / hybrid); skipped for pure full-attention
archs.  Nothing else is skipped.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from .base import ModelConfig

_MODULES = {
    "mamba2-1.3b": "mamba2_1p3b",
    "h2o-danube-1.8b": "h2o_danube_1p8b",
    "minicpm-2b": "minicpm_2b",
    "deepseek-67b": "deepseek_67b",
    "llama3-405b": "llama3_405b",
    "deepseek-v3-671b": "deepseek_v3_671b",
    "qwen3-moe-235b-a22b": "qwen3_moe_235b",
    "whisper-tiny": "whisper_tiny",
    "recurrentgemma-9b": "recurrentgemma_9b",
    "llama-3.2-vision-90b": "llama32_vision_90b",
}

ARCH_IDS: Tuple[str, ...] = tuple(_MODULES)

# archs with sub-quadratic sequence mixing (may run long_500k)
SUBQUADRATIC = ("mamba2-1.3b", "h2o-danube-1.8b", "recurrentgemma-9b")


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str          # train | prefill | decode
    seq_len: int
    global_batch: int


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


def get_config(arch: str, *, smoke: bool = False) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {list(_MODULES)}")
    mod = importlib.import_module(f".{_MODULES[arch]}", __package__)
    return mod.SMOKE if smoke else mod.CONFIG


def cell_applicable(arch: str, shape: str) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped) for one (arch x shape) cell."""
    if shape == "long_500k" and arch not in SUBQUADRATIC:
        return False, "full attention: 500k KV/decode skipped (DESIGN.md §4)"
    return True, ""


def all_cells() -> List[Tuple[str, str, bool, str]]:
    """All 40 (arch, shape, runnable, reason) cells."""
    out = []
    for arch in ARCH_IDS:
        for shape in SHAPES:
            ok, why = cell_applicable(arch, shape)
            out.append((arch, shape, ok, why))
    return out


def memory_len(cfg: ModelConfig, seq_len: int) -> Optional[int]:
    """Stub-frontend memory length for one cell (audio frames / image
    patches); None for text-only archs."""
    if cfg.enc_layers > 0:
        return int(seq_len * cfg.enc_seq_ratio)
    if cfg.n_image_tokens > 0:
        return cfg.n_image_tokens
    return None
