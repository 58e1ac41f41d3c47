"""Mixture-of-Experts FFN with capacity-based scatter dispatch.

Counterpart of ``repro/models/moe.py``.  Dispatch avoids the (T, E, C)
one-hot tensors of GShard-style einsum MoE:
  1. router top-k per token (fp32),
  2. rank within each expert by a stable sort of the expert ids,
  3. capacity-clipped scatter into an (E, C, D) buffer,
  4. batched per-expert SwiGLU products,
  5. gather-back weighted by normalized gates, summed over each token's k
     assignments (dropped ones contribute 0 and fall through on the
     residual path).

Aux load-balancing loss per Switch/GShard: E * sum_e f_e * p_e.

Under ``distributed.sharding.use_mesh`` with a "model" axis of more than
one rank, ``moe_apply`` takes the expert-parallel path
(``moe_apply_sharded``), as the reference's does: each model rank holds
E / model experts and runs the tokens routed to them.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
from torch import distributed as dist
from torch import nn
from torch.distributed.tensor import DTensor
from torch.nn import functional as F

from ..configs.base import ModelConfig
from ..distributed import sharding as shd
from .layers import MLP, dense_init, dtype_of, empty_param, mlp_apply, \
    pdtype_of


class MoE(nn.Module):
    """Parameters ``w_router`` (d, E), fp32 whatever the param dtype, as in
    the reference; ``we_g``, ``we_u`` (E, d, F) and ``we_d`` (E, F, d); and,
    with shared experts, ``shared`` (an MLP of width F * n_shared)."""

    def __init__(self, cfg: ModelConfig, device):
        super().__init__()
        e, d, f = cfg.n_experts, cfg.d_model, cfg.expert_ff
        self.w_router = empty_param((d, e), cfg, device, dtype=torch.float32)
        self.we_g = empty_param((e, d, f), cfg, device)
        self.we_u = empty_param((e, d, f), cfg, device)
        self.we_d = empty_param((e, f, d), cfg, device)
        self.has_shared = cfg.n_shared_experts > 0
        if self.has_shared:
            self.shared = MLP(cfg, device, width=f * cfg.n_shared_experts)

    @torch.no_grad()
    def init(self, generator: torch.Generator, cfg: ModelConfig):
        """The reference's distributions (``moe_init``).  The experts are
        drawn one at a time: at full width one whole (E, d, F) draw in fp32
        would be a temporary of many GB before the cast."""
        pd = pdtype_of(cfg)
        d = cfg.d_model
        std = d ** -0.5
        self.w_router.copy_(dense_init(generator, d, cfg.n_experts,
                                       torch.float32))
        for w, scale in ((self.we_g, std), (self.we_u, std),
                         (self.we_d, std * cfg.residual_scale)):
            for i in range(w.shape[0]):
                w[i].copy_((torch.randn(w.shape[1:], generator=generator,
                                        device=generator.device)
                            * scale).to(pd))
        if self.has_shared:
            self.shared.init(generator, cfg)


class Route(NamedTuple):
    """Where each of the T*k (token, choice) assignments goes, flattened
    token-major: ``gates`` (T*k,) fp32, normalized over each token's k;
    ``experts`` (T*k,); ``rank`` (T*k,), the assignment's place in its
    expert's queue; ``keep`` (T*k,), rank < cap; ``probs`` (T, E) fp32;
    ``cap``, the slots per expert."""
    gates: torch.Tensor
    experts: torch.Tensor
    rank: torch.Tensor
    keep: torch.Tensor
    probs: torch.Tensor
    cap: int


def capacity(cfg: ModelConfig, t: int) -> int:
    """Slots per expert for ``t`` tokens: capacity bounds memory at scale,
    and for small token counts (decode steps, smoke tests) drops would be an
    artifact, so it is floored at 8 slots (or the no-drop bound t*k when
    even smaller)."""
    k = cfg.top_k
    return min(t * k, max(int(cfg.capacity_factor * t * k / cfg.n_experts),
                          8))


def top_k(probs, k: int):
    """``jax.lax.top_k``: the k largest along the last dim, ties broken
    towards the lower index (a stable descending sort; ``torch.topk``
    promises no order among ties)."""
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], ids[..., :k]


def route(p: MoE, xt, cfg: ModelConfig) -> Route:
    """Router, top-k and each assignment's rank within its expert, for
    tokens ``xt`` (T, d)."""
    t = xt.shape[0]
    k = cfg.top_k
    logits = xt.float() @ p.w_router                           # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_ids = top_k(probs, k)                    # (T, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    flat_e = expert_ids.reshape(-1)                            # (T*k,)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    group_start = torch.searchsorted(
        sorted_e, torch.arange(cfg.n_experts, device=xt.device))
    rank_sorted = torch.arange(t * k, device=xt.device) \
        - group_start[sorted_e]
    rank = torch.empty_like(flat_e)
    rank[order] = rank_sorted
    cap = capacity(cfg, t)
    return Route(gate_vals.reshape(-1), flat_e, rank, rank < cap, probs, cap)


def aux_loss(r: Route, cfg: ModelConfig):
    """The load-balancing loss: fraction routed against mean probability,
    per expert."""
    e = cfg.n_experts
    t = r.probs.shape[0]
    f_e = torch.bincount(r.experts, minlength=e).float() / t   # (E,)
    p_e = r.probs.mean(dim=0)
    return cfg.router_aux_coef * e * torch.sum(f_e * p_e)


def moe_apply(p: MoE, x, cfg: ModelConfig) -> Tuple[torch.Tensor,
                                                    torch.Tensor]:
    """x: (B, S, D) -> (out, aux_loss).  Routes to the expert-parallel
    path when a mesh with a >1 "model" axis is active."""
    mesh = shd.active_mesh()
    if mesh is not None and shd.axis_size("model") > 1:
        return moe_apply_sharded(p, x, cfg, mesh=mesh,
                                 dp_axes=shd.dp_axes_of(shd.current_rules()))
    return _moe_apply_gspmd(p, x, cfg)


def _moe_apply_gspmd(p: MoE, x, cfg: ModelConfig) -> Tuple[torch.Tensor,
                                                           torch.Tensor]:
    """The reference's one-device path."""
    dt = dtype_of(cfg)
    b, s, d = x.shape
    t = b * s
    k = cfg.top_k
    xt = x.reshape(t, d)
    r = route(p, xt, cfg)
    aux = aux_loss(r, cfg)

    flat_tok = torch.arange(t, device=x.device).repeat_interleave(k)
    # The reference scatters with mode="drop"; index_put would raise on a
    # rank past the buffer, so only the kept assignments are scattered.
    kept = torch.nonzero(r.keep).squeeze(1)
    ebuf = torch.zeros((cfg.n_experts, r.cap, d), dtype=dt,
                       device=x.device).index_put(
        (r.experts[kept], r.rank[kept]), xt[flat_tok[kept]].to(dt))

    h = F.silu(torch.bmm(ebuf, p.we_g.to(dt))) * torch.bmm(ebuf,
                                                           p.we_u.to(dt))
    y = torch.bmm(h, p.we_d.to(dt))                            # (E, C, D)

    gathered = y[r.experts, torch.clamp(r.rank, max=r.cap - 1)]
    contrib = torch.where(r.keep[:, None],
                          gathered * r.gates[:, None].to(dt), 0.0)
    # The reference scatter-adds each assignment into its token's row.  A
    # token's k assignments are consecutive (token-major), so that is a sum
    # over each group of k rows; summed so, the result does not depend on
    # the order of a bf16 index_add_'s atomic adds on the card.
    out = contrib.reshape(t, k, d).sum(dim=1)
    if p.has_shared:
        out = out + mlp_apply(p.shared, xt, cfg)
    return out.reshape(b, s, d), aux


def moe_apply_reference(p: MoE, x, cfg: ModelConfig):
    """Dense loop-over-experts oracle (no capacity drops), for tests."""
    dt = dtype_of(cfg)
    b, s, d = x.shape
    xt = x.reshape(-1, d)
    probs = torch.softmax(xt.float() @ p.w_router, dim=-1)
    gate_vals, expert_ids = top_k(probs, cfg.top_k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)
    out = torch.zeros_like(xt)
    for ei in range(cfg.n_experts):
        h = F.silu(xt @ p.we_g[ei].to(dt)) * (xt @ p.we_u[ei].to(dt))
        ye = h @ p.we_d[ei].to(dt)
        w = torch.where(expert_ids == ei, gate_vals, 0.0).sum(dim=-1)
        out = out + ye * w[:, None].to(dt)
    if p.has_shared:
        out = out + mlp_apply(p.shared, xt, cfg)
    return out.reshape(b, s, d)


# ---------------------------------------------------------------------------
# Expert-parallel path (the reference's shard_map path).
#
# Activations are replicated across "model", so dispatch needs NO token
# all-to-all: each model rank extracts the tokens routed to ITS experts
# (local gather + capacity scatter), runs the expert FFN locally, and the
# ranks' partial outputs are summed over "model".  Communication per layer
# = one (T_local, D) all-reduce.  Here each rank runs this as its own code
# with explicit collectives (``distributed.sharding``): x holds the rank's
# rows of the batch (its DP block), the same on every rank of a model group.
# ---------------------------------------------------------------------------

def local_route(expert_ids, e_loc: int, rank_id: int, cap_local: int):
    """This model rank's part of the routing of ``expert_ids`` (T, k):
    (flat_e, rank, keep, mine), each (T*k,).  ``mine``: the assignment
    goes to one of this rank's experts; ``flat_e``: its local expert (the
    sentinel ``e_loc`` where not mine); ``rank``: its place in that
    expert's queue (the order the one-device path ranks in); ``keep``:
    mine and rank < cap_local."""
    local_ids = expert_ids.reshape(-1) - rank_id * e_loc
    mine = (local_ids >= 0) & (local_ids < e_loc)
    flat_e = torch.where(mine, local_ids, e_loc)               # sentinel last
    n = flat_e.shape[0]
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    group_start = torch.searchsorted(
        sorted_e, torch.arange(e_loc + 1, device=flat_e.device))
    rank = torch.empty_like(flat_e)
    rank[order] = torch.arange(n, device=flat_e.device) \
        - group_start[sorted_e]
    return flat_e, rank, mine & (rank < cap_local), mine


def _moe_dispatch_local(xt, gate_vals, expert_ids, we_g, we_u, we_d, *,
                        cap_local: int, rank_id: int, dt):
    """Per-rank body.  xt: (T_loc, D); gate_vals, expert_ids: (T_loc, k);
    we_*: this rank's (E_loc, D, F) / (E_loc, F, D) block, experts
    ``rank_id * E_loc`` on.  Returns the rank's partial output (T_loc, D):
    the sum over the model ranks is the reference's body (its psum)."""
    t_loc, d = xt.shape
    e_loc = we_g.shape[0]
    k = expert_ids.shape[-1]
    flat_e, rank, keep, mine = local_route(expert_ids, e_loc, rank_id,
                                           cap_local)
    flat_g = torch.where(mine, gate_vals.reshape(-1), 0.0)
    flat_tok = torch.arange(t_loc, device=xt.device).repeat_interleave(k)

    kept = torch.nonzero(keep).squeeze(1)
    ebuf = torch.zeros((e_loc, cap_local, d), dtype=dt,
                       device=xt.device).index_put(
        (flat_e[kept], rank[kept]), xt[flat_tok[kept]].to(dt))
    h = F.silu(torch.bmm(ebuf, we_g.to(dt))) * torch.bmm(ebuf, we_u.to(dt))
    y = torch.bmm(h, we_d.to(dt))                              # (E_loc, C, D)

    gathered = y[torch.clamp(flat_e, max=e_loc - 1),
                 torch.clamp(rank, max=cap_local - 1)]
    contrib = torch.where(keep[:, None], gathered * flat_g[:, None].to(dt),
                          0.0)
    return contrib.reshape(t_loc, k, d).sum(dim=1)


def expert_shardings(model: nn.Module, mesh) -> dict:
    """{name: NamedSharding} placing every MoE layer's expert weights on
    dim 0 over "model" (each rank holds E / model experts), for
    ``distributed.sharding.distribute_params``; every other parameter stays
    whole on each rank."""
    return {name: shd.NamedSharding(mesh, ("model", None, None))
            for name, _ in model.named_parameters()
            if name.rsplit(".", 1)[-1] in shd.EXPERT}


def _expert_block(w, mesh, model_axis: str):
    """This rank's experts of ``w``, a DTensor placed by
    ``expert_shardings``."""
    want = shd.placements((model_axis, None, None), mesh)
    if not isinstance(w, DTensor) or tuple(w.placements) != want:
        raise ValueError(f"expert weights must be DTensors placed {want} "
                         f"(distribute_params(model, expert_shardings(model, "
                         f"mesh))), not {getattr(w, 'placements', 'whole')}")
    return w.to_local()


def moe_apply_sharded(p: MoE, x, cfg: ModelConfig, *, mesh, dp_axes,
                      model_axis: str = "model"):
    """Expert-parallel MoE over ``mesh`` (a DeviceMesh).  x: (B_loc, S, D),
    this rank's rows (the batch split over ``dp_axes``).  Router and aux
    stay global: the aux loss's f_e and p_e are means over the whole batch
    (summed over the DP ranks).  Gradients: see ``distributed.sharding``;
    a rank's aux gradient covers its own rows, so the one-device gradient
    is the sum over the DP ranks, as for the rest of its loss.

    In a DTensor step (every parameter placed by the sharding rules) the
    region runs on each rank's block: its rows, the whole router, and its
    experts (gathered over the FSDP axis, as the reference's shard_map
    in_specs gather them); the shared experts stay outside, on the
    DTensors, as in the reference."""
    if isinstance(x, DTensor):
        def body(x, w_router, we_g, we_u, we_d):
            return _moe_sharded_local(x, w_router, (we_g, we_u, we_d), cfg,
                                      mesh=mesh, dp_axes=dp_axes,
                                      model_axis=model_axis)
        rows = ("batch", None, None)
        experts = ("experts", None, None)
        out, aux = shd.per_shard(
            body, (x, p.w_router, p.we_g, p.we_u, p.we_d),
            (rows, (None, None), experts, experts, experts),
            (rows, ()), (x.shape, ()), reduces=(model_axis,))
    else:
        experts = tuple(_expert_block(w, mesh, model_axis)
                        for w in (p.we_g, p.we_u, p.we_d))
        out, aux = _moe_sharded_local(x, p.w_router, experts, cfg,
                                      mesh=mesh, dp_axes=dp_axes,
                                      model_axis=model_axis)
    if p.has_shared:
        out = out + mlp_apply(p.shared, x, cfg)
    return out, aux


def _moe_sharded_local(x, w_router, experts, cfg: ModelConfig, *, mesh,
                       dp_axes, model_axis: str):
    """A rank's part of ``moe_apply_sharded`` without the shared experts:
    x (B_loc, S, D) its rows, ``w_router`` whole, ``experts`` its
    (we_g, we_u, we_d) blocks."""
    dt = dtype_of(cfg)
    b, s, d = x.shape
    t_loc = b * s
    e, k = cfg.n_experts, cfg.top_k
    model_group = mesh.get_group(model_axis)
    n_model = shd.mesh_shape(mesh)[model_axis]
    if e % n_model:
        raise ValueError(f"{e} experts do not split over {n_model} ranks")
    cap_local = capacity(cfg, t_loc)            # from the DP-local tokens

    xt = x.reshape(t_loc, d)
    probs = torch.softmax(xt.float() @ w_router, dim=-1)
    gate_vals, expert_ids = top_k(probs, k)
    gate_vals = gate_vals / gate_vals.sum(dim=-1, keepdim=True)

    f_e = torch.bincount(expert_ids.reshape(-1), minlength=e).float() / t_loc
    p_e = probs.mean(dim=0)
    dp_groups = shd.groups_of(mesh, dp_axes)
    for g in dp_groups:
        f_e = shd.reduce_from(f_e, g)
        p_e = shd.reduce_from(p_e, g)
    n_dp = math.prod(dist.get_world_size(g) for g in dp_groups)
    aux = cfg.router_aux_coef * e * torch.sum((f_e / n_dp) * (p_e / n_dp))

    out = _moe_dispatch_local(
        shd.copy_to(xt, model_group), shd.copy_to(gate_vals, model_group),
        expert_ids, *experts,
        cap_local=cap_local, rank_id=mesh.get_local_rank(model_axis), dt=dt)
    out = shd.reduce_from(out, model_group)
    return out.reshape(b, s, d), aux
