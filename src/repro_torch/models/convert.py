"""Load the reference's parameter pytree into the port's model, so that both
packages compute the same function.

The reference (``repro/models/model.py:33-72``) keeps each block parameter
STACKED over groups under ``params["groups"]["b<i>"]``, leading dim
n_groups; the port keeps one module per group (``groups.<g>.b<i>``).  Leaf
names are the same on both sides, so the mapping is by path.
"""
from __future__ import annotations

from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import DeviceLike
from .model import LanguageModel


def _leaves(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, object]]:
    for key, val in tree.items():
        if isinstance(val, Mapping):
            yield from _leaves(val, f"{prefix}{key}.")
        else:
            yield f"{prefix}{key}", val


def _tensor(a, device, dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # numpy's bf16 (ml_dtypes): torch
        a = a.astype(np.float32)         # cannot wrap it; the cast is exact
    return torch.tensor(a, device=device, dtype=dtype)   # a copy


def params_from_jax(tree: Mapping, cfg: ModelConfig,
                    device: DeviceLike = None,
                    dtype: Optional[torch.dtype] = None) -> LanguageModel:
    """tree: the reference's params as numpy arrays (``jax.tree.map(
    np.asarray, params)``).  Returns a port model holding the same values on
    ``device``, with ``dtype`` (default: the config's) as its param dtype.

    Each leaf is loaded at the dtype of the port parameter it fills, which
    keeps the reference's dtype roles: the leaves the reference pins to
    fp32 (mamba2's ``a_log``, ``dt_bias``, ``d_skip``) stay fp32 under a
    bf16 param dtype.  A leaf the port model does not hold, or a parameter
    no leaf fills, raises."""
    if dtype is not None:
        cfg = cfg.replace(param_dtype=str(dtype).removeprefix("torch."))
    model = LanguageModel(cfg, device)
    want = model.state_dict()
    state: Dict[str, torch.Tensor] = {}

    def put(path, a):
        if path not in want:
            raise KeyError(f"reference leaf {path!r} has no counterpart in "
                           f"the port model")
        state[path] = _tensor(a, model.device, want[path].dtype)

    for path, a in _leaves(tree):
        if not path.startswith("groups."):
            put(path, a)
            continue
        a = np.asarray(a)
        if a.shape[0] != cfg.n_groups:
            raise ValueError(f"{path}: leading dim {a.shape[0]} is not "
                             f"n_groups={cfg.n_groups}")
        rest = path[len("groups."):]
        for g in range(cfg.n_groups):
            put(f"groups.{g}.{rest}", a[g])
    model.load_state_dict(state, strict=True)
    return model
