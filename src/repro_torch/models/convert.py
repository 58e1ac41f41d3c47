"""Carry parameters and train states between the reference's pytree layout
and the port's model, in both directions, so that both packages compute the
same function and a checkpoint written by either restores in the other.

The reference (``repro/models/model.py:33-72``) keeps each block parameter
STACKED over groups under ``params["groups"]["b<i>"]``, leading dim
n_groups, each dense prefix block parameter stacked over the
``first_dense`` blocks under ``params["prefix"]``, and each encoder block
parameter stacked over the ``enc_layers`` blocks one level down, under
``params["encoder"]["blocks"]``; the port keeps one module per group
(``groups.<g>.b<i>``), per prefix block (``prefix.<i>``) and per encoder
block (``encoder.blocks.<i>``).  The MTP head (``mtp``) and the encoder's
``final_norm`` are not stacked.  A 0-d leaf of a block (the cross-attention
gate ``xgate``) stacks to (n,).  Leaf names are the same on both sides, so
the mapping is by path.  A train state
(``train.train_step.init_state``) holds named tensors in the port's names:
``params``, the optimizer's ``mu`` / ``nu`` and, with compressed gradients,
``residuals``; each maps the same way, and the optimizer's ``step`` as it
is.  Int8 moments (``optim.quantized_moments.q8nd_init``) are a dict
``{"q", "scale"}`` for each parameter, whose two tensors stack over the
groups as a parameter does (``opt/mu/groups/b0/attn/wq/q``); the moments of
a per-group 0-d parameter are held already stacked, under the reference's
leaf path (``groups.b0.xgate``), and cross as they are.
"""
from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterator, Mapping, Optional, Tuple

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import DeviceLike
from .model import LanguageModel


STACKED = ("groups", "prefix", "encoder.blocks")


def _stack_of(path: str) -> Optional[str]:
    """The stacked part (an entry of STACKED) a path lies in, or None."""
    return next((head for head in STACKED if path.startswith(head + ".")),
                None)


def split_stacked(name: str) -> Optional[Tuple[str, int]]:
    """A port parameter name in a stacked part -> (the reference's leaf
    path, the index along its leading dim): ``groups.3.b0.attn.wq`` ->
    (``groups.b0.attn.wq``, 3), ``encoder.blocks.1.ln1`` ->
    (``encoder.blocks.ln1``, 1).  None for a name outside them."""
    head = _stack_of(name)
    if head is None:
        return None
    i, rest = name[len(head) + 1:].split(".", 1)
    return f"{head}.{rest}", int(i)


def _unstacked_names(path: str, n: int) -> Iterator[str]:
    """The reference's stacked leaf path -> the port's names of its ``n``
    slices."""
    head = _stack_of(path)
    rest = path[len(head) + 1:]
    return (f"{head}.{i}.{rest}" for i in range(n))


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
    fp32 (mamba2's ``a_log``, ``dt_bias``, ``d_skip``, the RG-LRU's ``lam``,
    the MoE router) stay fp32 under a bf16 param dtype.  A leaf the port
    model does not hold, or a parameter no leaf fills, raises."""
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

    depth = {"groups": ("n_groups", cfg.n_groups),
             "prefix": ("first_dense", cfg.first_dense),
             "encoder.blocks": ("enc_layers", cfg.enc_layers)}
    for path, a in _leaves(tree):
        head = _stack_of(path)
        if head is None:
            put(path, a)
            continue
        a = np.asarray(a)
        field, n = depth[head]
        if a.shape[0] != n:
            raise ValueError(f"{path}: leading dim {a.shape[0]} is not "
                             f"{field}={n}")
        for i, name in enumerate(_unstacked_names(path, n)):
            put(name, a[i])
    model.load_state_dict(state, strict=True)
    return model


def _nest(flat: Mapping[str, object]) -> Dict:
    """{"a.b.c": leaf} -> {"a": {"b": {"c": leaf}}}."""
    tree: Dict = {}
    for path, leaf in flat.items():
        *parents, last = path.split(".")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def _is_stacked_leaf(path: str) -> bool:
    """A reference leaf path in a stacked part (``groups.b0.xgate``), as
    against a port name there (``groups.3.b0.xgate``)."""
    head = _stack_of(path)
    return head is not None and \
        not path[len(head) + 1:].split(".", 1)[0].isdigit()


def jax_layout(named: Mapping[str, torch.Tensor]) -> Dict:
    """Tensors named as the port's parameters (``groups.<g>.b0.attn.wq``, a
    model's ``named_parameters`` or state dict, its gradients or moments) ->
    the reference's nested layout, group leaves stacked over the groups
    (``{"groups": {"b0": {"attn": {"wq": (n_groups, ...)}}}}``) and prefix
    leaves over the prefix blocks.  Leaves are CPU copies, detached, in
    their own dtype.  Encoder block leaves are stacked over the encoder's
    blocks under ``{"encoder": {"blocks": ...}}``.  A tensor named by a
    stacked leaf's own path (``groups.b0.xgate.q``) is that leaf already."""
    flat: Dict[str, torch.Tensor] = {}
    stacks = defaultdict(dict)
    for path, t in named.items():
        stacked = None if _is_stacked_leaf(path) else split_stacked(path)
        if stacked:
            stacks[stacked[0]][stacked[1]] = t.detach()
        else:
            flat[path] = t.detach().to("cpu", copy=True)
    for path, per_group in stacks.items():
        if sorted(per_group) != list(range(len(per_group))):
            raise ValueError(f"{path}: indices {sorted(per_group)} are not "
                             f"0..n-1")
        flat[path] = torch.stack([per_group[g] for g in
                                  range(len(per_group))]).cpu()
    return _nest(flat)


def _numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.bfloat16:
        # numpy holds bf16 only through ml_dtypes (JAX's dtype package);
        # the bits are carried over as they are
        import ml_dtypes
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def params_to_jax(model: LanguageModel) -> Dict:
    """The inverse of ``params_from_jax``: the model's parameters as the
    reference's params pytree, numpy leaves in the stacked ``groups``
    layout, each in its parameter's dtype (bf16 leaves as ``ml_dtypes``
    arrays, which is how the reference hands them to numpy)."""
    return _map_leaves(jax_layout(model.state_dict()), _numpy)


def _map_leaves(tree: Mapping, fn) -> Dict:
    return {k: _map_leaves(v, fn) if isinstance(v, Mapping) else fn(v)
            for k, v in tree.items()}


def _named_moments(moments: Mapping) -> Dict[str, torch.Tensor]:
    """A state's ``mu`` or ``nu`` as named tensors: int8 moments' ``q`` and
    ``scale`` under ``<name>.q`` and ``<name>.scale``."""
    named = {}
    for name, m in moments.items():
        if isinstance(m, Mapping):
            named.update((f"{name}.{part}", t) for part, t in m.items())
        else:
            named[name] = m
    return named


def state_to_jax(state: Mapping) -> Dict:
    """A port train state -> the reference's train-state pytree
    (``repro/train/train_step.py:init_state``): ``params``, ``opt`` (``mu``,
    ``nu``, ``step``) and, when present, ``residuals``, in the stacked
    layout.  Leaves are CPU tensor copies in their own dtype: what
    ``train.checkpoint.save`` writes under the reference's leaf names
    (``params/groups/b0/attn/wq``, ``opt/step``)."""
    opt = state["opt"]
    tree = {"params": jax_layout(state["params"]),
            "opt": {"mu": jax_layout(_named_moments(opt["mu"])),
                    "nu": jax_layout(_named_moments(opt["nu"])),
                    "step": opt["step"].detach().to("cpu", copy=True)}}
    if "residuals" in state:
        tree["residuals"] = jax_layout(state["residuals"])
    return tree


def _unstack(tree: Mapping, whole=frozenset()) -> Dict[str, object]:
    """The reference's nested layout -> leaves named as the port's; the
    stacked leaves in ``whole`` (the int8 moments of a per-group 0-d
    parameter, which the port holds stacked) keep their path."""
    flat: Dict[str, object] = {}
    for path, a in _leaves(tree):
        if _stack_of(path) and path not in whole:
            for i, name in enumerate(_unstacked_names(path, a.shape[0])):
                flat[name] = a[i]
        else:
            flat[path] = a
    return flat


@torch.no_grad()
def state_from_jax(tree: Mapping, state: Dict) -> Dict:
    """Copy a reference-layout train state (``state_to_jax``'s layout; numpy
    or tensor leaves, as ``train.checkpoint.restore`` returns them) into the
    port train state ``state`` IN PLACE, each leaf cast to the dtype of the
    tensor it fills; returns ``state``.  Both must hold the same leaves:
    a missing or extra leaf, or a shape that differs, raises."""
    pairs = [(tree["params"], state["params"]),
             (tree["opt"]["mu"], _named_moments(state["opt"]["mu"])),
             (tree["opt"]["nu"], _named_moments(state["opt"]["nu"]))]
    if "residuals" in state:
        pairs.append((tree["residuals"], state["residuals"]))
    for sub, named in pairs:
        flat = _unstack(sub, {n for n in named if _is_stacked_leaf(n)})
        if set(flat) != set(named):
            raise KeyError(f"leaves differ: only in the tree "
                           f"{sorted(set(flat) - set(named))}, only in the "
                           f"state {sorted(set(named) - set(flat))}")
        for path, t in named.items():
            src = flat[path]
            if not isinstance(src, torch.Tensor):
                src = _tensor(src, "cpu", t.dtype)
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{path}: shape {tuple(src.shape)} does "
                                 f"not fit {tuple(t.shape)}")
            t.copy_(src)
    step = state["opt"]["step"]
    state["opt"]["step"] = torch.as_tensor(np.asarray(
        tree["opt"]["step"])).to(dtype=torch.int32, device=step.device)
    return state
