"""Sharding rules: logical axes -> mesh axes, param specs by naming
convention, activation constraints, and the collectives of the per-rank
(manual) regions.

Counterpart of ``repro/distributed/sharding.py``.  Parallelism layout:
  * batch ("batch")            -> ("pod", "data")     DP across pods+pod-local
  * params (FSDP dim)          -> "data"              ZeRO-3 inside a pod,
                                                      replicated across pods
  * heads / ffn / experts /
    vocab ("tensor" dims)      -> "model"             TP/EP
  * long-context KV seq        -> "data"              SP (batch=1 decode)

Param placement is inferred from leaf NAMES (naming convention, enforced by
the model code):
  TP on last dim : wq wk wv wg wu wi w_router w_dkv w_uk w_uv w_qa w_qb
                   lm_head w_gates
  TP on first dim: wo wd w_out
  tok_embed      : vocab dim (0) on "model"
  1-D / conv / scalars: replicated.
FSDP shards the largest non-TP dim on "data".

A spec is the reference's ``PartitionSpec`` as plain data: a tuple with one
entry per tensor dim, each None, a mesh axis name, or a tuple of names (the
dim split over several axes, major first).  A mesh is a
``torch.distributed.device_mesh.DeviceMesh`` with named dims; where only
the sizes matter (the rules, the divisibility guard) a mapping of axis name
to size stands in for it.  ``placements`` turns a spec into DTensor
placements on a DeviceMesh, and ``distribute`` places a tensor so.

The port keeps one module per block group, so its parameters have no
stacked leading dim: the reference's spec of a stacked leaf is
``(None, *spec)`` of the port's parameter (``models/convert.py`` maps the
names).  The reference's ``shard_map`` regions are written here as
per-rank code with explicit collectives (``copy_to``, ``reduce_from``,
``split_to``, ``gather_from``), each an autograd function, so that the
gradients each rank computes are the one-device gradients; its
``shard_map`` version shim has no counterpart.
"""
from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Mapping, NamedTuple, Optional, Tuple, Union

import torch
from torch import distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                      distribute_tensor)

Axes = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Axes, ...]
MeshLike = Union[DeviceMesh, Mapping[str, int]]

TP_LAST = {"wq", "wk", "wv", "wg", "wu", "wi", "w_router", "w_dkv", "w_uk",
           "w_uv", "w_qa", "w_qb", "lm_head", "w_gates", "w_in", "wx", "wy",
           "w_z", "w_xs", "w_dtp"}
# mamba2's w_b / w_c deliberately NOT TP (2N per token is tiny; computing
# B/C replicated avoids per-head all-reduces in the SSD contraction)
TP_FIRST = {"wo", "wd", "w_out"}
EXPERT = {"we_g", "we_u", "we_d"}          # (E, in, out): EP on dim 0
EMBED = {"tok_embed", "frame_embed", "patch_embed"}

_ACTIVE_MESH: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=None)
_RULES: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_rules", default=None)
_MANUAL: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_manual", default=False)


@contextlib.contextmanager
def manual_region():
    """Mark a per-rank body: constrain() must no-op on manual axes."""
    tok = _MANUAL.set(True)
    try:
        yield
    finally:
        _MANUAL.reset(tok)


# logical activation axis -> mesh axes
DEFAULT_RULES = {
    "batch": ("pod", "data"),
    "seq": None,
    "kv_seq": None,            # set to "data" for long-context SP plans
    "heads": "model",
    "head_shard": "model",     # inner (vectorized) head axis in SSD blocks
    "embed": None,
    "ffn": "model",
    "vocab": "model",
    "experts": "model",
    "fsdp": "data",
}


def mesh_shape(mesh: Optional[MeshLike]) -> Optional[Dict[str, int]]:
    """{axis name: size} of a DeviceMesh or a shape mapping; None for
    None."""
    if mesh is None:
        return None
    if isinstance(mesh, DeviceMesh):
        return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    return {str(k): int(v) for k, v in mesh.items()}


@contextlib.contextmanager
def use_mesh(mesh: MeshLike, rules: Optional[dict] = None):
    """Install mesh + rules for constrain()/param_specs() lookups, and for
    the sharded paths (``models.moe``, ``models.ssm``), which need a
    DeviceMesh."""
    rules = dict(DEFAULT_RULES, **(rules or {}))
    # drop mesh axes that don't exist (single-pod meshes have no "pod")
    axis_names = set(mesh_shape(mesh))

    def filt(v):
        if v is None:
            return None
        if isinstance(v, str):
            return v if v in axis_names else None
        vv = tuple(a for a in v if a in axis_names)
        return vv or None
    rules = {k: filt(v) for k, v in rules.items()}
    tok_m = _ACTIVE_MESH.set(mesh)
    tok_r = _RULES.set(rules)
    try:
        yield
    finally:
        _ACTIVE_MESH.reset(tok_m)
        _RULES.reset(tok_r)


def reentry():
    """A context manager factory that installs the mesh, rules and manual
    flag active now, for work that runs later elsewhere: a checkpointed
    block's recompute runs in the autograd engine's thread, which does not
    see this thread's use_mesh().  None outside use_mesh()."""
    saved = (_ACTIVE_MESH.get(), _RULES.get(), _MANUAL.get())
    if saved[0] is None:
        return None

    @contextlib.contextmanager
    def again():
        toks = [var.set(val) for var, val in
                zip((_ACTIVE_MESH, _RULES, _MANUAL), saved)]
        try:
            yield
        finally:
            for var, tok in zip((_MANUAL, _RULES, _ACTIVE_MESH),
                                reversed(toks)):
                var.reset(tok)
    return again


def active_mesh() -> Optional[MeshLike]:
    """The mesh installed by use_mesh(), or None."""
    return _ACTIVE_MESH.get()


def current_rules() -> Optional[dict]:
    return _RULES.get()


def axis_size(name: str) -> int:
    """Size of a mesh axis under the active mesh (1 outside use_mesh)."""
    shape = mesh_shape(_ACTIVE_MESH.get())
    if shape is None:
        return 1
    return int(shape.get(name, 1))


def logical_rank(logical: str) -> Tuple[int, int]:
    """(this rank's index, the number of ranks) along the mesh axes the
    active rules split ``logical`` over, major axis first; (0, 1) where it
    is not split."""
    mesh, rules = _ACTIVE_MESH.get(), _RULES.get() or {}
    axes = rules.get(logical)
    axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
    rank, n = 0, 1
    for a in axes:
        size = int(mesh_shape(mesh)[a])
        rank, n = rank * size + mesh.get_local_rank(a), n * size
    return rank, n


def dp_axes_of(rules: Optional[dict]) -> Tuple[str, ...]:
    """The mesh axes the batch is split over, as a tuple (the reference's
    ``dp_axes`` of the sharded paths)."""
    dp = (rules or {}).get("batch")
    return (dp,) if isinstance(dp, str) else tuple(dp or ())


def placements(spec: Spec, mesh: DeviceMesh) -> tuple:
    """DTensor placements of ``spec`` on ``mesh``: one per mesh dim,
    ``Shard(d)`` where the spec puts that mesh axis on tensor dim d, else
    ``Replicate()``.  A dim split over several axes (the ``("pod",
    "data")`` batch) is sharded over them in the mesh's order, which is
    the only order a DTensor splits in, so the spec must name them so."""
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for d, axes in enumerate(spec):
        if axes is None:
            continue
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes {axes} of dim {d} are not "
                             f"in the mesh's order {tuple(names)}")
        for i in idx:
            if not isinstance(out[i], Replicate):
                raise ValueError(f"spec {spec}: mesh axis {names[i]!r} is "
                                 f"on two dims")
            out[i] = Shard(d)
    return tuple(out)


class NamedSharding(NamedTuple):
    """A spec on a mesh: the reference's ``NamedSharding``."""
    mesh: DeviceMesh
    spec: Spec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def distribute(tensor: torch.Tensor, sharding: NamedSharding) -> DTensor:
    """``tensor`` placed as ``sharding`` says, as a DTensor: the
    reference's ``jax.device_put(x, sharding)``.  Every rank passes the
    same whole tensor (on any device; it is moved to the mesh's device
    type) and keeps its own block, with no collective; the block is a copy,
    so the whole tensor can be freed."""
    mesh = sharding.mesh
    whole = tensor.detach().to(mesh.device_type)
    dt = distribute_tensor(whole, mesh, sharding.placements,
                           src_data_rank=None)
    local = dt.to_local()
    if local.untyped_storage().data_ptr() == \
            whole.untyped_storage().data_ptr():
        local = local.clone()
    return DTensor.from_local(local, mesh, dt.placements, run_check=False,
                              shape=dt.shape, stride=dt.stride())


def constrain(x, logical: Tuple[Optional[str], ...]):
    """The reference's with_sharding_constraint via logical axis names: a
    no-op outside use_mesh(), in a manual region, and on a plain tensor
    (the reference's value outside a mesh); a DTensor is redistributed to
    the logical axes' placements on the active mesh."""
    mesh = _ACTIVE_MESH.get()
    rules = _RULES.get()
    if mesh is None or rules is None or _MANUAL.get() \
            or not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, placements(_resolve(logical), mesh))


def _resolve(logical) -> Spec:
    rules = _RULES.get() or {}
    return tuple(rules.get(a) if a else None for a in logical)


def per_shard(fn, args, logical, out_logical, out_shape=None, *,
              reduces: Tuple[str, ...] = ()):
    """``fn(*args)``, run on this rank's blocks where the reference's
    partitioner keeps the work local and DTensor has no sharding rule for
    it (a reshape that splits a sharded dim, a scan, a decode step).

    On plain tensors, outside use_mesh() or in a manual region, this is
    ``fn(*args)``.  Otherwise each DTensor arg is redistributed to the
    placements of its logical axes (``logical``, one tuple per arg, None
    for an arg that is not a DTensor), ``fn`` runs on the local blocks,
    and its output is this rank's block of a DTensor placed by
    ``out_logical`` (one tuple, or one per output when ``fn`` returns a
    tuple) with the global ``out_shape`` (default: inferred from an even
    split).

    Gradients: the ranks along a mesh axis that any arg or output is split
    over each do their own share of the work, so an arg replicated over
    that axis gets a partial gradient there (summed when it flows back
    into its DTensor), as ``copy_to`` does.  ``reduces`` names the mesh
    axes whose gradients ``fn`` sums itself (a region written with its own
    collectives, as the reference's ``shard_map`` bodies); there the
    gradients come back placed as the args."""
    mesh = _ACTIVE_MESH.get()
    if mesh is None or _RULES.get() is None or _MANUAL.get() \
            or not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    want = [None if lg is None else placements(_resolve(lg), mesh)
            for lg in logical]
    outs = out_logical if out_logical and all(
        isinstance(lg, tuple) for lg in out_logical) else (out_logical,)
    names = mesh.mesh_dim_names
    split = {i for pl in want + [placements(_resolve(lg), mesh)
                                 for lg in outs] if pl
             for i, p in enumerate(pl)
             if isinstance(p, Shard) and names[i] not in reduces}
    local = []
    for a, pl in zip(args, want):
        if not isinstance(a, DTensor):
            local.append(a)
            continue
        grad = tuple(Partial() if i in split and isinstance(p, Replicate)
                     else p for i, p in enumerate(pl))
        local.append(_DenseGrad.apply(
            a.redistribute(mesh, pl).to_local(grad_placements=grad)))
    with manual_region():
        out = fn(*local)
    if isinstance(out, tuple):      # one logical spec and shape per output
        return tuple(_placed(o, lg, sh, mesh)
                     for o, lg, sh in zip(out, out_logical, out_shape))
    return _placed(out, out_logical, out_shape, mesh)


class _DenseGrad(torch.autograd.Function):
    """Identity whose gradient is made contiguous: a DTensor's gradient
    block must have the layout of the DTensor it flows into."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.contiguous()


def _placed(local: torch.Tensor, logical, shape, mesh) -> DTensor:
    pl = placements(_resolve(logical), mesh)
    if shape is None:
        return DTensor.from_local(local, mesh, pl, run_check=False)
    # a block with the whole tensor's contiguous layout
    local = local.contiguous()
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_strides(shape))


def _contiguous_strides(shape) -> Tuple[int, ...]:
    out, step = [], 1
    for n in reversed(tuple(shape)):
        out.append(step)
        step *= max(int(n), 1)
    return tuple(reversed(out))


def replicated(x: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered whole onto every rank (its redistribution to
    Replicate on every mesh axis); a plain tensor as it is."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh,
                          (Replicate(),) * x.device_mesh.ndim)


def whole_units(x: torch.Tensor, dim: int, units: int) -> torch.Tensor:
    """A DTensor whose ``dim`` is split over more ranks than it has
    ``units`` (heads) to split into, or a number that does not divide
    them, gathered along ``dim`` first, so that the reshape into units
    stays on each rank (the reference's partitioner pads instead); a plain
    tensor, or one that splits whole, as it is."""
    if not isinstance(x, DTensor):
        return x
    mesh = x.device_mesh
    pls = tuple(Replicate() if p.is_shard(dim) and units % mesh.size(i)
                else p for i, p in enumerate(x.placements))
    if pls == tuple(x.placements):
        return x
    return x.redistribute(mesh, pls)


def zeros_as(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Zeros of ``t``'s shape in ``dtype`` on its device; for a DTensor,
    placed as it is (each rank allocates its block)."""
    if isinstance(t, DTensor):
        return torch.zeros_like(t, dtype=dtype)
    return torch.zeros(t.shape, dtype=dtype, device=t.device)


def split_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    """(B, ...) -> (n, B / n, ...).  A DTensor split over its batch dim is
    split on each rank: microbatch i is every rank's i-th block of rows
    (the same sizes as the global split, with no collective)."""
    if not isinstance(x, DTensor) or all(
            not p.is_shard(0) for p in x.placements):
        return x.reshape(n, x.shape[0] // n, *x.shape[1:])
    local = x.to_local()
    local = local.reshape(n, local.shape[0] // n, *local.shape[1:])
    pls = tuple(Shard(p.dim + 1) if p.is_shard() else p
                for p in x.placements)
    shape = (n, x.shape[0] // n, *x.shape[1:])
    return DTensor.from_local(local, x.device_mesh, pls, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_strides(shape))


def set_slot(t: torch.Tensor, dim: int, index: int, value) -> None:
    """``t[:, ..., index] = value`` along ``dim``, in place: a cache write.
    On a DTensor sharded along ``dim`` only the rank that holds the slot
    writes it (``value`` placed as ``t`` without that dim); the placement
    is kept."""
    if not isinstance(t, DTensor):
        t[(slice(None),) * dim + (index,)] = value
        return
    mesh, pls = t.device_mesh, tuple(t.placements)
    lo, size = 0, t.shape[dim]
    for i, p in enumerate(pls):
        if isinstance(p, Shard) and p.dim == dim:
            size = -(-size // mesh.size(i))
            lo += size * mesh.get_local_rank(i)
    vpl = tuple(p if not isinstance(p, Shard) or p.dim < dim
                else (Replicate() if p.dim == dim else Shard(p.dim - 1))
                for p in pls)
    if isinstance(value, DTensor):
        value = value.redistribute(mesh, vpl).to_local()
    local = t.to_local()
    if lo <= index < lo + local.shape[dim]:
        local[(slice(None),) * dim + (index - lo,)] = value


def _axes_size(mesh_shape: Optional[dict], axes) -> int:
    if mesh_shape is None or axes is None:
        return 1
    if isinstance(axes, str):
        return int(mesh_shape.get(axes, 1))
    n = 1
    for a in axes:
        n *= int(mesh_shape.get(a, 1))
    return n


def _guard(spec_list, shape, mesh_shape):
    """Replace axis assignments whose size does not divide the dim with
    None (divisibility guard; e.g. minicpm's 122753 vocab)."""
    out = []
    for dim, axes in zip(shape, spec_list):
        if axes is None:
            out.append(None)
            continue
        n = _axes_size(mesh_shape, axes)
        if isinstance(axes, tuple) and len(axes) == 1:
            axes = axes[0]          # as PartitionSpec normalises it
        out.append(axes if n > 0 and dim % n == 0 else None)
    return out


def leaf_spec(path: str, shape, *, rules: dict,
              stacked: bool = False,
              mesh_shape: Optional[dict] = None) -> Spec:
    """Spec for one param leaf from its name ("/"-joined path) + shape."""
    shape = tuple(shape)
    parts = path.split("/")
    name = parts[-1]
    # q8 moment leaves (optim/quantized_moments.q8nd_*): inherit the parent
    # weight's spec on the leading dims; q carries an extra trailing
    # (blocks, 256) split of the last dim, scale carries (blocks[, 2]).
    if name in ("q", "scale") and len(parts) >= 2:
        if name == "q" and len(shape) >= 2:
            base = leaf_spec("/".join(parts[:-1]), shape[:-1], rules=rules,
                             stacked=stacked, mesh_shape=mesh_shape)
            return (*base, None)
        if name == "scale" and len(shape) >= 1:
            # nonneg scales end with a packed [lmin, lrange] pair dim
            trailing_pair = shape[-1] == 2 and len(shape) >= 2
            core = shape[:-1] if trailing_pair else shape
            base = leaf_spec("/".join(parts[:-1]), core, rules=rules,
                             stacked=stacked, mesh_shape=mesh_shape)
            return (*base, None) if trailing_pair else base
    tp = rules.get("heads") or rules.get("ffn")
    fsdp = rules.get("fsdp")
    lead_n = 1 if stacked else 0
    body = len(shape) - lead_n
    bshape = shape[lead_n:]
    lead = (None,) * lead_n

    if body <= 1:
        return (*lead, *((None,) * body))
    if name in EMBED:
        spec = [tp, fsdp] + [None] * (body - 2)    # (V, D)
    elif name in EXPERT:
        spec = [tp, fsdp] + [None] * (body - 2)    # (E, in, out): EP
    elif name in TP_LAST:
        spec = [None] * body
        spec[-1] = tp
        spec[0] = fsdp
    elif name in TP_FIRST:
        spec = [None] * body
        spec[0] = tp
        spec[-1] = fsdp
    else:
        spec = [None] * body
        spec[0] = fsdp if body >= 2 else None
    spec = _guard(spec, bshape, mesh_shape)
    return (*lead, *spec)


def _named(params) -> Mapping[str, object]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return params


def param_specs(params, *, rules: Optional[dict] = None,
                mesh: Optional[MeshLike] = None) -> Dict[str, Spec]:
    """{name: spec} for ``params``: a model, or tensors (or anything with a
    ``shape``) named as the port's parameters (``groups.3.b0.attn.wq``)
    and their int8 moments (``<name>.q``, ``<name>.scale``).  A port
    parameter of a stacked part has no leading group dim; a leaf the port
    holds stacked (the int8 moments of a per-group 0-d parameter, named by
    the reference's leaf path ``groups.b0.xgate``) gets the reference's
    stacked spec.  ``mesh`` (or the active mesh) enables the divisibility
    guard."""
    from ..models.convert import _is_stacked_leaf
    rules = rules if rules is not None else (_RULES.get() or DEFAULT_RULES)
    mesh = mesh if mesh is not None else _ACTIVE_MESH.get()
    shape = mesh_shape(mesh)
    out = {}
    for name, leaf in _named(params).items():
        stacked = _is_stacked_leaf(name.removesuffix(".q")
                                   .removesuffix(".scale"))
        out[name] = leaf_spec(name.replace(".", "/"), tuple(leaf.shape),
                              rules=rules, stacked=stacked,
                              mesh_shape=shape)
    return out


def tree_shardings(mesh: DeviceMesh, specs):
    """A tree (nested dicts and lists) of specs -> the same tree of
    NamedSharding.  A spec is a tuple, so a list is a node of the tree (the
    port's cache holds one entry per group)."""
    if isinstance(specs, Mapping):
        return {k: tree_shardings(mesh, v) for k, v in specs.items()}
    if isinstance(specs, list):
        return [tree_shardings(mesh, v) for v in specs]
    return NamedSharding(mesh, tuple(specs))


def param_shardings(mesh: DeviceMesh, params, **kw
                    ) -> Dict[str, NamedSharding]:
    return tree_shardings(mesh, param_specs(params, mesh=mesh, **kw))


def distribute_params(model: nn.Module,
                      shardings: Mapping[str, NamedSharding]) -> nn.Module:
    """Replace each parameter of ``model`` named in ``shardings`` by a
    DTensor parameter placed so (``distribute``), IN PLACE; the others stay
    as they are.  Returns ``model``."""
    for name, sharding in shardings.items():
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        old = getattr(owner, leaf)
        setattr(owner, leaf, nn.Parameter(distribute(old, sharding),
                                          requires_grad=old.requires_grad))
        del old
    return model


# ---------------------------------------------------------------------------
# batch / cache shardings
# ---------------------------------------------------------------------------

def _map_tree(fn, tree, path: str = ""):
    if isinstance(tree, Mapping):
        return {k: _map_tree(fn, v, f"{path}{k}/") for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_tree(fn, v, f"{path}{i}/")
                          for i, v in enumerate(tree))
    return fn(path.rstrip("/"), tree)


def batch_specs_tree(batch, *, rules: Optional[dict] = None,
                     mesh: Optional[MeshLike] = None):
    """Specs for a data batch: dim 0 (global batch) over the DP axes,
    guarded for divisibility (long_500k has batch 1 -> replicated)."""
    rules = rules if rules is not None else (_RULES.get() or DEFAULT_RULES)
    mesh = mesh if mesh is not None else _ACTIVE_MESH.get()
    shape = mesh_shape(mesh)
    dp = rules.get("batch")

    def spec_of(_, leaf):
        if len(leaf.shape) == 0:
            return ()
        spec = [dp] + [None] * (len(leaf.shape) - 1)
        return tuple(_guard(spec, leaf.shape, shape))

    return _map_tree(spec_of, batch)


# cache leaf name -> (which dim gets the DP axes, which gets "model")
_CACHE_LAYOUT = {
    # stacked caches: dim0 = layer group
    "k": (1, 2),        # (G, B, S, Hkv, hd): B->dp, S->model (seq shard)
    "v": (1, 2),
    "latent": (1, 2),   # (G, B, S, rank)
    "k_rope": (1, 2),
    "ssm": (1, 2),      # (G, B, H, N, P): B->dp, H->model
    "conv": (1, 3),     # (G, B, w, C): B->dp, C->model
    "h": (1, 2),        # (G, B, W): B->dp, W->model
}


def cache_specs_tree(cache, *, rules: Optional[dict] = None,
                     mesh: Optional[MeshLike] = None):
    """Specs for decode caches (divisibility-guarded), by leaf name.  A
    leaf of the reference's stacked layout has a leading group dim; a leaf
    of the port's cache (``LanguageModel.init_cache``: a list entry per
    group or prefix block) has none, and its spec is the stacked leaf's
    without that dim's None."""
    rules = rules if rules is not None else (_RULES.get() or DEFAULT_RULES)
    mesh = mesh if mesh is not None else _ACTIVE_MESH.get()
    shape = mesh_shape(mesh)
    dp = rules.get("batch")
    tp = rules.get("heads") or rules.get("ffn")

    def spec_of(path, leaf):
        name = path.split("/")[-1]
        ndim = len(leaf.shape)
        layout = _CACHE_LAYOUT.get(name)
        spec = [None] * ndim
        if layout is not None:
            per_group = any(p.isdigit() for p in path.split("/")[:-1])
            dp_dim, tp_dim = (d - per_group for d in layout)
            if dp_dim < ndim:
                spec[dp_dim] = dp
            if tp_dim < ndim:
                spec[tp_dim] = tp
        return tuple(_guard(spec, leaf.shape, shape))

    return _map_tree(spec_of, cache)


# ---------------------------------------------------------------------------
# collectives of the per-rank regions (the reference's shard_map bodies)
#
# Outside a region every rank holds the same values (replicated over the
# group) and the same gradients.  Four crossings keep it so, each the
# adjoint of the other's pair (Megatron-LM's f / g):
#   copy_to      replicated -> region: identity; backward all-reduce (the
#                region's ranks each computed part of the gradient),
#   reduce_from  region -> replicated: all-reduce (sum of the ranks'
#                partial results); backward identity,
#   split_to     replicated -> this rank's block along a dim; backward
#                all-gather,
#   gather_from  blocks -> replicated, concatenated along a dim; backward
#                this rank's block.
# Only all-reduce and all-gather are used (gloo has both, for CPU and CUDA
# tensors).  A sum is reduced in fp32 (a bf16 partial is cast up and the
# sum cast back), which for two ranks is the bf16 sum's own rounding.
# ---------------------------------------------------------------------------

def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    buf = x.float().contiguous()
    if buf is x:
        buf = buf.clone()
    dist.all_reduce(buf, group=group)
    return buf.to(x.dtype)


def _all_gather(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x)
             for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def _block(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    n = dist.get_world_size(group)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of size {x.shape[dim]} does not split "
                         f"over {n} ranks")
    return x.chunk(n, dim=dim)[dist.get_rank(group)].contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SplitTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _block(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.dim, ctx.group), None, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dim, group):
        ctx.dim, ctx.group = dim, group
        return _all_gather(x, dim, group)

    @staticmethod
    def backward(ctx, g):
        return _block(g, ctx.dim, ctx.group), None, None


def copy_to(x: torch.Tensor, group) -> torch.Tensor:
    return _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group) -> torch.Tensor:
    return _ReduceFrom.apply(x, group)


def split_to(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _SplitTo.apply(x, dim, group)


def gather_from(x: torch.Tensor, dim: int, group) -> torch.Tensor:
    return _GatherFrom.apply(x, dim, group)


def groups_of(mesh: DeviceMesh, axes) -> list:
    """The process groups of ``axes`` (a name or names) on ``mesh`` that
    this rank belongs to, one per axis of size > 1: a sum over all of them,
    one after another, is the sum over the axes together."""
    axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
    shape = mesh_shape(mesh)
    return [mesh.get_group(a) for a in axes if shape.get(a, 1) > 1]
