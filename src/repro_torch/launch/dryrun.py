"""Dry run: every (arch x shape x mesh) cell traced on one rank of a fake
256- or 512-rank process group, priced on the H100.

Counterpart of ``repro/launch/dryrun.py``, with its plans, CLI and JSONL
row keys.  The reference lowers and compiles each step for 256 or 512
placeholder TPU devices and reads XLA's cost and memory analyses.  Here
"lowering" is a trace:

  * the world is ``launch.mesh.fake_world`` (rank 0 of a fake process
    group), the mesh ``make_production_mesh`` over it;
  * the model is built on the meta device, and every parameter, optimizer
    moment, batch input and decode cache is a DTensor placed by the
    sharding rules (``distributed.sharding``), whose local block is a meta
    tensor wrapped in ``_Local``;
  * the step (``make_train_step``, ``make_prefill``, ``make_serve_step``)
    then runs eagerly under ``use_mesh``.  No memory is allocated and no
    kernel runs (``use_flash_kernel`` is off, as in the reference's).

Every op DTensor runs on a rank's block passes through ``_Local``'s
dispatch, where ``StepTrace`` counts it on the block's (local) shapes:

  * FLOPs by ``torch.utils.flop_counter``'s formulas (the matmuls);
  * bytes as each op's inputs read once and outputs written once, unfused,
    views free: above XLA's post-fusion "bytes accessed";
  * collectives by ``launch.hlo_analysis.CollectiveCounter``;
  * memory as the live meta storages of the rank and their peak.

Totals are per rank times the ranks, as the reference scales XLA's
per-partition counts.  A meta tensor has no values, so the two ops whose
output shape depends on them are given the shape the reference's
fixed-shape code has: ``nonzero`` keeps every element (the reference's
scatter with mode="drop" runs them all) and ``bincount`` has its
``minlength``.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time
import weakref
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Replicate
from torch.distributed.tensor.experimental import implicit_replication
from torch.nn.utils import parametrize
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..configs import SHAPES, all_cells, cell_applicable, get_config, \
    memory_len
from ..configs.base import ModelConfig
from ..configs.registry import ShapeSpec
from ..core import hardware
from ..core.hardware import HardwareParams
from ..data import make_batch_specs
from ..distributed import sharding
from ..models import build
from ..optim.schedule import for_arch
from ..train.serve_step import make_prefill, make_serve_step
from ..train.train_step import init_state, make_train_step
from . import hlo_analysis
from .mesh import NVLINK_BYTES_PER_S_ONE_WAY, fake_world, \
    make_production_mesh

# ---------------------------------------------------------------------------
# Per-cell execution plans (baseline), the reference's.
# ---------------------------------------------------------------------------

BIG = ("deepseek-67b", "llama3-405b", "deepseek-v3-671b",
       "qwen3-moe-235b-a22b", "llama-3.2-vision-90b")


def plan_for(arch: str, shape: str, cfg: ModelConfig) -> Dict:
    """Baseline execution plan: sharding-rule overrides + microbatches +
    optimizer dtypes.  The reference's plan, verbatim, so that both
    packages trace the same one; the row's ``fits`` says whether it fits
    the H100."""
    plan: Dict = {"rules": {}, "microbatches": 1,
                  "moment_dtype": None, "accum_dtype": "float32",
                  "remat": None}
    if cfg.d_model >= 7168:
        # shard the residual stream's hidden dim over "model" so the
        # per-layer residuals stay O(D/16) per rank
        plan["rules"]["embed"] = "model"
    if arch in BIG:
        plan["moment_dtype"] = "bfloat16"
        plan["accum_dtype"] = "bfloat16"
    if shape == "train_4k":
        # global batch 256: grad-accumulate in 8 microbatches.  The
        # dominant temporaries (the fp32 logits chain, each layer's saved
        # activations) scale with the tokens live at once.
        plan["microbatches"] = 8
    if shape == "long_500k":
        plan["rules"]["batch"] = None     # batch 1: DP axes idle
    return plan


def model_flops_for(cfg: ModelConfig, shape_name: str) -> float:
    """MODEL_FLOPS = 6*N*D (dense) / 6*N_active*D (MoE), N excluding
    embeddings; D = tokens processed by the lowered step."""
    return _model_flops(cfg, SHAPES[shape_name])


def _model_flops(cfg: ModelConfig, shape: ShapeSpec) -> float:
    n_embed = cfg.vocab * cfg.d_model * (1 if cfg.tie_embeddings else 2)
    n = cfg.active_param_count() - n_embed
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    return 2.0 * n * shape.global_batch      # decode: 1 token per sequence


# ---------------------------------------------------------------------------
# The roofline, priced on a HardwareParams (default: the H100 data sheet)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RooflineReport:
    """Three-term roofline per (arch x shape x mesh): the reference's
    ``core/tpu.py`` formulas, with the rates a field of the report (bf16
    peak, HBM rate and one link rate per rank) instead of a TPU's
    constants.  All terms in seconds."""

    name: str
    num_chips: int
    hlo_flops: float              # whole-program FLOPs (all ranks)
    hlo_bytes: float              # whole-program bytes accessed
    collective_bytes: float       # summed collective operand bytes
    model_flops: float            # 6*N*D (dense) / 6*N_active*D (MoE)
    peak_flops: float
    hbm_bw: float
    link_bw: float

    @property
    def compute_term(self) -> float:
        return self.hlo_flops / (self.num_chips * self.peak_flops)

    @property
    def memory_term(self) -> float:
        return self.hlo_bytes / (self.num_chips * self.hbm_bw)

    @property
    def collective_term(self) -> float:
        return self.collective_bytes / (self.num_chips * self.link_bw)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_term, "memory": self.memory_term,
                 "collective": self.collective_term}
        return max(terms, key=terms.get)

    @property
    def bound_time(self) -> float:
        return max(self.compute_term, self.memory_term, self.collective_term)

    @property
    def useful_flops_ratio(self) -> float:
        """MODEL_FLOPS / traced FLOPs: the share of the compute that is
        'useful' (catches remat and redundant work)."""
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """compute_term / bound_time: 1.0 == compute-bound at the
        roofline."""
        b = self.bound_time
        return self.compute_term / b if b > 0 else 0.0


def report_from_artifacts(name: str, *, num_chips: int,
                          cost_analysis: Dict[str, float],
                          collective_bytes: float, model_flops: float,
                          hw: Optional[HardwareParams] = None
                          ) -> RooflineReport:
    """The report of one cell's counts, priced on ``hw`` (default the
    ``h100`` data sheet file): its bf16 tensor peak and HBM rate, and
    NVLink 4's one-way rate for every link (the file has none)."""
    hw = hw or hardware.get("h100")
    return RooflineReport(
        name=name, num_chips=num_chips,
        hlo_flops=float(cost_analysis.get("flops", 0.0)),
        hlo_bytes=float(cost_analysis.get("bytes accessed", 0.0)),
        collective_bytes=collective_bytes, model_flops=model_flops,
        peak_flops=hw.tensor_peak_flops["bf16"], hbm_bw=hw.hbm_peak_bw,
        link_bw=NVLINK_BYTES_PER_S_ONE_WAY)


# ---------------------------------------------------------------------------
# The trace: a rank's blocks as meta tensors whose every op is counted
# ---------------------------------------------------------------------------

class _Local(torch.Tensor):
    """A rank's block of a traced DTensor (or a plain tensor of the
    traced step): a meta tensor ``elem`` whose ops its ``trace``
    counts."""

    __torch_function__ = torch._C._disabled_torch_function_impl

    @staticmethod
    def __new__(cls, elem: torch.Tensor, trace: "StepTrace"):
        r = torch.Tensor._make_wrapper_subclass(
            cls, elem.size(), strides=elem.stride(),
            storage_offset=elem.storage_offset(), dtype=elem.dtype,
            device=elem.device, requires_grad=False)
        r.elem = elem
        r.trace = trace
        return r

    def __repr__(self):
        return f"_Local({tuple(self.shape)}, {self.dtype})"

    @classmethod
    def __torch_dispatch__(cls, func, types, args=(), kwargs=None):
        trace = next(a.trace for a in _flat((args, kwargs or {}))
                     if type(a) is _Local)
        return trace.run(func, args, kwargs or {})


def _nonzero(x, **_):
    return torch.empty((x.numel(), x.dim()), dtype=torch.long, device="meta")


def _bincount(x, weights=None, minlength=0):
    dt = torch.long if weights is None else weights.dtype
    return torch.empty((minlength,), dtype=dt, device="meta")


_META_RULES = {
    torch.ops.aten.nonzero.default: _nonzero,
    torch.ops.aten.bincount.default: _bincount,
}


def _flat(args):
    """The tensors of an op's args and kwargs, through lists and dicts
    (``cat``'s list, the collectives' lists of lists)."""
    for a in (args.values() if isinstance(args, dict) else args):
        if isinstance(a, torch.Tensor):
            yield a
        elif isinstance(a, (list, tuple, dict)):
            yield from _flat(a)


def _tensor_bytes(*trees) -> float:
    return float(sum(t.numel() * t.element_size() for t in _flat(trees)))


def _unwrap(a):
    if type(a) is _Local:
        return a.elem
    if isinstance(a, (list, tuple)):
        return type(a)(_unwrap(x) for x in a)
    return a


class _OpInfo:
    """What the trace needs to know of an op, looked up once."""

    __slots__ = ("composite", "flops", "view", "inplace")

    def __init__(self, func):
        self.composite = torch._C._dispatch_has_kernel_for_dispatch_key(
            func.name(), torch._C.DispatchKey.CompositeImplicitAutograd)
        self.flops = flop_registry.get(func.overloadpacket)
        self.view = func.is_view
        self.inplace = func._schema.is_mutable


_INFO: Dict[object, _OpInfo] = {}


class StepTrace:
    """Counts of one traced step on one rank: ``flops``, ``bytes``,
    ``collectives`` (a ``hlo_analysis.CollectiveCounter``), and the live
    bytes of the rank's storages with their ``peak``.  Ops count only
    between ``start()`` and ``stop()``; storages are tracked throughout.

    A storage that only a reference cycle still holds is free, but its
    finalizer runs only when Python's cycle collector does (DTensor's
    sharding propagation keeps exceptions whose tracebacks hold an op's
    tensors), so the peak would depend on when the collector happens to
    run.  ``_tracing`` stops it running on its own and freezes the objects
    made before the trace out of it.  The step runs it at its start and
    whenever the live bytes would pass the peak by more than
    ``1/2**PEAK_SLACK_SHIFT`` of it: the peak is then each step's own,
    and is low by less than that share."""

    PEAK_SLACK_SHIFT = 6

    def __init__(self, mesh):
        self.flops = 0.0
        self.bytes = 0.0
        self.collectives = hlo_analysis.CollectiveCounter(mesh)
        self.live = 0
        self.peak = 0
        self.counting = False
        self._storages: Dict[int, list] = {}

    def start(self):
        gc.collect()
        self.counting = True

    def stop(self):
        self.counting = False

    def track(self, t: "_Local") -> "_Local":
        st = t.elem.untyped_storage()
        key = st._cdata
        rec = self._storages.get(key)
        if rec is None:
            rec = self._storages[key] = [0, st.nbytes()]
            self.live += rec[1]
            if self.live > self.peak and not self.counting:
                self.peak = self.live
            elif self.live > self.peak + (self.peak
                                          >> self.PEAK_SLACK_SHIFT):
                gc.collect()
                self.peak = max(self.peak, self.live)
        rec[0] += 1
        weakref.finalize(t, self._release, key)
        return t

    def _release(self, key):
        rec = self._storages[key]
        rec[0] -= 1
        if rec[0] == 0:
            self.live -= rec[1]
            del self._storages[key]

    def run(self, func, args, kwargs):
        info = _INFO.get(func)
        if info is None:
            info = _INFO[func] = _OpInfo(func)
        if info.composite:
            # in inference mode a composite op (matmul, einsum) arrives
            # whole: count the ops it is made of
            out = func.decompose(*args, **kwargs)
            if out is not NotImplemented:
                return out
        ua = _unwrap(args)
        uk = {k: _unwrap(v) for k, v in kwargs.items()} if kwargs else {}
        rule = _META_RULES.get(func)
        out = rule(*ua, **uk) if rule else func(*ua, **uk)
        if self.counting and not self.collectives.record(func, ua, uk):
            if info.flops is not None:
                self.flops += info.flops(*ua, **uk, out_val=out)
            if not info.view:
                self.bytes += _tensor_bytes(ua, uk) \
                    + (0.0 if info.inplace else _tensor_bytes(out))
        if isinstance(out, torch.Tensor):
            return self._wrap(out, args)
        if isinstance(out, (list, tuple)):
            return type(out)(self._wrap(o, args) if isinstance(
                o, torch.Tensor) else o for o in out)
        return pytree.tree_map(lambda o: self._wrap(o, args), out)

    def _wrap(self, o, args):
        if type(o) is not torch.Tensor:
            return o
        for a in _flat(args):
            if type(a) is _Local and a.elem is o:    # in place: the same
                return a
        return self.track(_Local(o, self))


class _PlainMetaMode(TorchDispatchMode):
    """Brings the step's plain meta tensors (masks, positions, scalars
    made with ``device=x.device``) into ``trace``: an op whose tensors
    are all plain meta tensors runs through it and returns ``_Local``s."""

    def __init__(self, trace: StepTrace):
        super().__init__()
        self.trace = trace

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        leaves = [t for t in pytree.tree_leaves((args, kwargs))
                  if isinstance(t, torch.Tensor)]
        if leaves:
            plain_meta = all(type(t) is torch.Tensor and t.is_meta
                             for t in leaves)
        else:                       # a factory: traced if made on meta
            device = kwargs.get("device")
            plain_meta = device is not None and \
                torch.device(device).type == "meta"
        if not plain_meta:
            return func(*args, **kwargs)
        return self.trace.run(func, args, kwargs)


@contextlib.contextmanager
def _all_to_all():
    """DTensor's Shard -> Shard moves as the all-to-all they are on the
    card: on a "cpu" mesh DTensor stands in an all-gather of the whole
    dim and a chunk of it (gloo has no all-to-all), a transient the card
    never holds.  A torch without the hook is refused, so that no row
    counts the stand-in."""
    from torch.distributed.tensor import placement_types as pt
    if not hasattr(pt, "shard_dim_alltoall") or not hasattr(
            torch.ops._dtensor, "shard_dim_alltoall"):
        raise RuntimeError(f"torch {torch.__version__}: DTensor has no "
                           "shard_dim_alltoall to count as an all-to-all")

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        return torch.ops._dtensor.shard_dim_alltoall(
            input, gather_dim, shard_dim,
            mesh.get_group(mesh_dim).group_name)
    prev = pt.shard_dim_alltoall
    pt.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        pt.shard_dim_alltoall = prev


@contextlib.contextmanager
def _tracing(mesh):
    """A StepTrace for ``mesh`` that the step's plain meta tensors join
    (they count as replicated DTensors, as a jitted reference step treats
    its constants)."""
    collecting = gc.isenabled()
    gc.disable()
    gc.freeze()
    trace = StepTrace(mesh)
    try:
        with implicit_replication(), _PlainMetaMode(trace), _all_to_all():
            yield trace
    finally:
        gc.unfreeze()
        if collecting:
            gc.enable()


def _local_shape(shape, placements, mesh) -> Tuple[int, ...]:
    """Rank 0's block of ``shape`` (the largest: torch.chunk's split)."""
    out = list(shape)
    for md, p in enumerate(placements):
        if p.is_shard():
            out[p.dim] = -(-out[p.dim] // mesh.size(md))
    return tuple(out)


def _block(shape, dtype, trace: StepTrace) -> _Local:
    t = torch.empty(shape, dtype=dtype, device="meta")
    # in the trace a plain meta tensor comes back traced already
    return t if type(t) is _Local else trace.track(_Local(t, trace))


def _place(t: torch.Tensor, spec, mesh, trace: StepTrace):
    """A meta stand-in for ``t`` (shape and dtype) placed by ``spec`` on
    ``mesh``; on a one-rank mesh a plain (traced) tensor."""
    if mesh.size() == 1:
        return _block(t.shape, t.dtype, trace)
    pl = sharding.placements(tuple(spec), mesh)
    local = _block(_local_shape(t.shape, pl, mesh), t.dtype, trace)
    return DTensor.from_local(local, mesh, pl, run_check=False,
                              shape=t.shape, stride=t.stride())


def _place_tree(tree, shardings, trace):
    if isinstance(tree, dict):
        return {k: _place_tree(v, shardings[k], trace)
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_place_tree(v, s, trace)
                          for v, s in zip(tree, shardings))
    return _place(tree, shardings.spec, shardings.mesh, trace)


class _Gathered(torch.nn.Module):
    """A parameter as the step reads it: gathered over the FSDP axes
    (ZeRO-3: all-gather before each use, its gradient reduce-scattered
    back), its tensor-parallel split kept."""

    def __init__(self, mesh_dims):
        super().__init__()
        self.mesh_dims = mesh_dims

    def forward(self, w):
        pls = tuple(Replicate() if i in self.mesh_dims else p
                    for i, p in enumerate(w.placements))
        return w.redistribute(w.device_mesh, pls)


def _place_params(model, mesh, trace):
    """Every parameter of the meta ``model`` placed by ``param_specs``,
    read as ``gather_fsdp`` says."""
    specs = sharding.param_specs(model, mesh=mesh)
    for name, spec in specs.items():
        owner_name, _, leaf = name.rpartition(".")
        owner = model.get_submodule(owner_name)
        old = getattr(owner, leaf)
        new = _place(old, spec, mesh, trace)
        setattr(owner, leaf, torch.nn.Parameter(new, requires_grad=False))
    gather_fsdp(model, mesh)


def gather_fsdp(model, mesh) -> None:
    """Read each DTensor parameter of ``model`` split over the active
    rules' "fsdp" axes through ``_Gathered`` (a parametrization, in
    place)."""
    fsdp = sharding.current_rules().get("fsdp")
    fsdp = (fsdp,) if isinstance(fsdp, str) else tuple(fsdp or ())
    dims = {i for i, a in enumerate(mesh.mesh_dim_names) if a in fsdp}
    for name, p in list(model.named_parameters()):
        if isinstance(p, DTensor) and any(p.placements[i].is_shard()
                                          for i in dims):
            owner_name, _, leaf = name.rpartition(".")
            parametrize.register_parametrization(
                model.get_submodule(owner_name), leaf, _Gathered(dims))


def _local_bytes(tree) -> int:
    return int(sum((t.to_local() if isinstance(t, DTensor) else t).numel()
                   * t.element_size() for t in pytree.tree_leaves(tree)
                   if isinstance(t, torch.Tensor)))


# ---------------------------------------------------------------------------
# Cell lowering
# ---------------------------------------------------------------------------

ACCOUNTING_ATTN_CHUNK = 4096   # same flop/byte totals, fewer, bigger ops


def _accounting_cfg(cfg: ModelConfig, groups: int) -> ModelConfig:
    """Reduced-depth config for cost accounting: 1 and 2 groups, and
    total(G) = f1 + (G-1)*(f2-f1) for flops / bytes / collectives
    (embed / head / optimizer-on-prefix terms live in the intercept).  In
    an eager trace every layer is seen, so the extrapolation is exact and
    only saves tracing time.  The scan and unroll switches stay, as in the
    reference; they shape nothing here."""
    plen = len(cfg.pattern)
    kw = dict(
        n_layers=cfg.first_dense + groups * plen,
        scan_layers=False,
        attn_chunk_unroll=True,
    )
    if cfg.attn_chunk > 0:
        kw["attn_chunk"] = ACCOUNTING_ATTN_CHUNK
    return cfg.replace(**kw)


def _lower_for(model, cfg, shape, mesh, plan, arch):
    if shape.kind == "train":
        return _lower_train(model, cfg, shape, mesh, plan, arch)
    if shape.kind == "prefill":
        return _lower_prefill(model, cfg, shape, mesh, plan)
    return _lower_decode(model, cfg, shape, mesh, plan)


def _cost_of(lowered: StepTrace, num_chips: int
             ) -> Tuple[float, float, float, object]:
    """GLOBAL flop / byte / collective totals of one trace: the rank's
    counts times the ranks (every rank runs the same shapes)."""
    stats = lowered.collectives.stats()
    return (lowered.flops * num_chips, lowered.bytes * num_chips,
            stats.total_bytes * num_chips, stats)


def account_cell(cfg, shape, mesh, plan, arch) -> Dict[str, float]:
    """Two-point group extrapolation of flops / bytes / collective bytes."""
    vals = []
    stats2 = None
    for g in (1, 2):
        cfg_g = _accounting_cfg(cfg, g)
        model_g = build(cfg_g, device="meta")
        plan_g = dict(plan, microbatches=1)
        with sharding.use_mesh(mesh, plan["rules"]):
            art = _lower_for(model_g, cfg_g, shape, mesh, plan_g, arch)
        f, b, c, stats = _cost_of(art["lowered"], mesh.size())
        vals.append((f, b, c))
        stats2 = stats
    g_full = cfg.n_groups
    out = {}
    for key, (v1, v2) in zip(("flops", "bytes", "collective_bytes"),
                             zip(*vals)):
        out[key] = v1 + (g_full - 1) * (v2 - v1)
        out[f"{key}_g1"] = v1
        out[f"{key}_g2"] = v2
    out["per_op_collectives_g2"] = dict(stats2.totals) if stats2 else {}
    return out


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               plan_override: Optional[Dict] = None,
               accounting: bool = True, mesh=None,
               cfg: Optional[ModelConfig] = None,
               shape: Optional[ShapeSpec] = None):
    """Trace one (arch x shape x mesh) cell, in the world the caller has
    opened (``fake_world``; ``mesh`` defaults to the production mesh,
    ``cfg`` to the arch's config, ``shape`` to ``SHAPES[shape_name]``).

    Two traces per cell:
      1. the DEPLOYED plan (remat + microbatches, full depth) -> the
         rank's memory: arguments, outputs and the peak of its live
         storages ("proves it fits"),
      2. the 1- and 2-group accounting traces -> flop / byte / collective
         totals by linear extrapolation (see _accounting_cfg).
    """
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    plan = plan_for(arch, shape_name, cfg)
    if plan_override:
        plan_override = dict(plan_override)
        plan["rules"].update(plan_override.pop("rules", {}))
        plan.update(plan_override)
    if plan.get("remat"):
        cfg = cfg.replace(remat=plan["remat"])
    if plan.get("cfg_overrides"):
        cfg = cfg.replace(**plan["cfg_overrides"])

    mesh = mesh if mesh is not None else \
        make_production_mesh(multi_pod=multi_pod, device="cpu")
    model = build(cfg, device="meta")
    t0 = time.time()

    with sharding.use_mesh(mesh, plan["rules"]):
        artifacts = _lower_for(model, cfg, shape, mesh, plan, arch)
    del model
    trace = artifacts["lowered"]
    t_compile = time.time() - t0
    stats = trace.collectives.stats()

    if accounting:
        acct = account_cell(cfg, shape, mesh, plan, arch)
        eff_cost = {"flops": acct["flops"], "bytes accessed": acct["bytes"]}
        coll_bytes = acct["collective_bytes"]
    else:
        acct = {}
        eff_cost = {"flops": trace.flops * mesh.size(),
                    "bytes accessed": trace.bytes * mesh.size()}
        coll_bytes = stats.total_bytes * mesh.size()

    hw = hardware.get("h100")
    report = report_from_artifacts(
        f"{arch}/{shape_name}/{_mesh_tag(mesh)}",
        num_chips=mesh.size(), cost_analysis=eff_cost,
        collective_bytes=coll_bytes,
        model_flops=_model_flops(cfg, shape), hw=hw)
    temp = max(trace.peak - artifacts["argument_bytes"], 0)
    mem = {"argument_bytes": artifacts["argument_bytes"],
           "output_bytes": artifacts["output_bytes"],
           "temp_bytes": temp,
           "generated_code_bytes": None}
    return {
        "trace": trace,
        "accounting": acct,
        "memory_analysis": mem,
        "fits": artifacts["argument_bytes"] + temp <= hw.hbm_capacity,
        "collectives": stats,
        "report": report,
        "compile_seconds": t_compile,
        "plan": plan,
        "mesh": mesh,
    }


def _mesh_tag(mesh) -> str:
    return "x".join(str(n) for n in mesh.mesh.shape)


def _batch_shardings(mesh, specs):
    pspecs = sharding.batch_specs_tree(specs, mesh=mesh)
    return sharding.tree_shardings(mesh, pspecs)


# Each step's inputs are described (shapes on the meta device) before its
# trace starts, and only their placed blocks are traced.

def _lower_train(model, cfg, shape, mesh, plan, arch):
    # the global batch, split over the DP axes
    batch_specs = make_batch_specs(cfg, batch=shape.global_batch,
                                   seq_len=shape.seq_len)
    with _tracing(mesh) as trace:
        _place_params(model, mesh, trace)
        state = init_state(model, moment_dtype=plan["moment_dtype"])
        batch = _place_tree(batch_specs,
                            _batch_shardings(mesh, batch_specs), trace)
        argument_bytes = _local_bytes((state, batch))
        lr = for_arch(arch, 3e-4, 2000, 100000)
        step = make_train_step(model, lr=lr,
                               microbatches=plan["microbatches"],
                               accum_dtype=plan.get("accum_dtype",
                                                    "float32"),
                               q8_moments=plan["moment_dtype"] == "int8")
        trace.start()
        state, metrics = step(state, batch)
        trace.stop()
        output_bytes = _local_bytes((state, metrics))
    return {"lowered": trace, "argument_bytes": argument_bytes,
            "output_bytes": output_bytes}


def _lower_prefill(model, cfg, shape, mesh, plan):
    batch_specs = make_batch_specs(cfg, batch=shape.global_batch,
                                   seq_len=shape.seq_len)
    batch_specs.pop("labels")
    # placed in inference mode, as the step runs: a view of a DTensor made
    # outside it cannot be taken inside
    with _tracing(mesh) as trace, torch.inference_mode():
        _place_params(model, mesh, trace)
        batch = _place_tree(batch_specs,
                            _batch_shardings(mesh, batch_specs), trace)
        argument_bytes = _local_bytes((dict(model.named_parameters()),
                                       batch))
        prefill = make_prefill(model)
        trace.start()
        logits = prefill(batch["tokens"], batch.get("memory_embeds"))
        trace.stop()
        output_bytes = _local_bytes(logits)
    return {"lowered": trace, "argument_bytes": argument_bytes,
            "output_bytes": output_bytes}


def _lower_decode(model, cfg, shape, mesh, plan):
    b = shape.global_batch
    cache_specs = model.init_cache(b, shape.seq_len)
    inputs = {"tokens": torch.empty((b, 1), dtype=torch.int32,
                                    device="meta")}
    mlen = memory_len(cfg, shape.seq_len)
    if mlen is not None:
        inputs["memory_embeds"] = torch.empty(
            (b, mlen, cfg.d_model), dtype=getattr(torch, cfg.dtype),
            device="meta")
    with _tracing(mesh) as trace, torch.inference_mode():
        _place_params(model, mesh, trace)
        cache = _place_tree(cache_specs, sharding.tree_shardings(
            mesh, sharding.cache_specs_tree(cache_specs, mesh=mesh)), trace)
        inputs = _place_tree(inputs, _batch_shardings(mesh, inputs), trace)
        argument_bytes = _local_bytes((dict(model.named_parameters()),
                                       cache, inputs))
        serve = make_serve_step(model)
        # the step at the end of the context: every cache slot is live
        trace.start()
        logits, cache = serve(cache, inputs["tokens"], shape.seq_len - 1,
                              inputs.get("memory_embeds"))
        trace.stop()
        output_bytes = _local_bytes((logits, cache))
    return {"lowered": trace, "argument_bytes": argument_bytes,
            "output_bytes": output_bytes}


# ---------------------------------------------------------------------------
# CLI
# ---------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, multi_pod: bool,
             json_out: Optional[str] = None, quiet: bool = False) -> Dict:
    """One cell's row, in a fake world of the mesh's ranks opened and
    closed here."""
    ok, why = cell_applicable(arch, shape_name)
    mesh_tag = "2x16x16" if multi_pod else "16x16"
    if not ok:
        row = {"arch": arch, "shape": shape_name, "mesh": mesh_tag,
               "status": "skipped", "reason": why}
        if not quiet:
            print(f"[dryrun] SKIP {arch} x {shape_name} x {mesh_tag}: {why}")
        if json_out:
            with open(json_out, "a") as f:
                f.write(json.dumps(row) + "\n")
        return row

    if not quiet:
        print(f"[dryrun] {arch} x {shape_name} x {mesh_tag} ...",
              flush=True)
    with fake_world(512 if multi_pod else 256):
        art = lower_cell(arch, shape_name, multi_pod=multi_pod)
    rep = art["report"]
    row = {
        "arch": arch, "shape": shape_name, "mesh": mesh_tag,
        "status": "ok",
        # DTensor plans its redistributions, and so the collectives, by
        # version
        "torch": torch.__version__,
        "chips": rep.num_chips,
        "hlo_flops": rep.hlo_flops,
        "hlo_bytes": rep.hlo_bytes,
        "collective_bytes": rep.collective_bytes,
        "model_flops": rep.model_flops,
        "compute_term_s": rep.compute_term,
        "memory_term_s": rep.memory_term,
        "collective_term_s": rep.collective_term,
        "dominant": rep.dominant,
        "useful_flops_ratio": rep.useful_flops_ratio,
        "roofline_fraction": rep.roofline_fraction,
        "compile_seconds": art["compile_seconds"],
        "collective_totals": dict(art["collectives"].totals),
        "plan": {k: v for k, v in art["plan"].items()},
        # memory of one rank: "proves it fits" (on the H100's 80 GB)
        "memory": art["memory_analysis"],
        "fits": art["fits"],
    }
    if not quiet:
        print(f"  trace {art['compile_seconds']:.1f}s | "
              f"flops {rep.hlo_flops:.3e} bytes {rep.hlo_bytes:.3e} "
              f"coll {rep.collective_bytes:.3e}")
        print(f"  terms: compute {rep.compute_term:.4e}s "
              f"memory {rep.memory_term:.4e}s "
              f"collective {rep.collective_term:.4e}s "
              f"-> {rep.dominant}-bound | useful {rep.useful_flops_ratio:.3f}")
        print(f"  memory_analysis: {row['memory']} fits {row['fits']}")
    if json_out:
        with open(json_out, "a") as f:
            f.write(json.dumps(row) + "\n")
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description="multi-pod dry-run")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--all", action="store_true",
                    help="run every (arch x shape) cell")
    ap.add_argument("--json", default=None, help="append JSONL rows here")
    args = ap.parse_args(argv)

    cells: list
    if args.all:
        cells = [(a, s) for a, s, _, _ in all_cells()]
    else:
        assert args.arch and args.shape, "--arch/--shape or --all"
        cells = [(args.arch, args.shape)]

    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    for arch, shape in cells:
        for mp in meshes:
            try:
                run_cell(arch, shape, mp, json_out=args.json)
            except Exception as e:                       # noqa: BLE001
                failures.append((arch, shape, mp, repr(e)))
                print(f"[dryrun] FAIL {arch} x {shape} "
                      f"(multi_pod={mp}): {e}", file=sys.stderr)
    if failures:
        print(f"[dryrun] {len(failures)} failures", file=sys.stderr)
        sys.exit(1)
    print("[dryrun] all requested cells compiled")


if __name__ == "__main__":
    main()
