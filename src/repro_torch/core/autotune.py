"""Model-driven plan selection (paper §IV-B 'adaptive tile selection',
generalized to SPMD execution plans — DESIGN.md §3).

The paper evaluates candidate GEMM tiles through the analytical model and
returns the argmin.  On a TPU pod the analogous knobs are the sharding plan
(how much TP vs DP/FSDP vs EP), the microbatch count, and the remat policy.
``enumerate_plans`` prices each candidate with the TPU stage + collective
models; ``select_plan`` returns the argmin.  This is the napkin-math engine
used by the §Perf hillclimbing loop.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from . import collectives as coll
from . import tpu
from .hardware import HardwareParams, TPU_V5E
from .workload import LatticeSpec, TileConfig, Workload, WorkloadTable


@dataclass(frozen=True)
class PlanCandidate:
    """One execution plan for a train/serve step on a mesh."""

    name: str
    mesh: coll.MeshSpec
    # model-parallel degree along "model" axis actually used by the plan
    tp_degree: int
    microbatches: int = 1
    remat: str = "none"              # none | block | full
    compressed_grads: bool = False   # int8 error-feedback all-reduce

    def describe(self) -> str:
        return (f"{self.name}: tp={self.tp_degree} ubatch={self.microbatches}"
                f" remat={self.remat} int8grads={self.compressed_grads}")


REMAT_FLOP_FACTOR = {"none": 1.0, "block": 4.0 / 3.0, "full": 5.0 / 3.0}


@dataclass(frozen=True)
class StepCost:
    plan: PlanCandidate
    compute_s: float
    memory_s: float
    collective_s: float
    exposed_collective_s: float
    total_s: float
    hbm_bytes_per_chip: float
    detail: Dict[str, float] = field(default_factory=dict)


def _collective_ops(plan: PlanCandidate, *, param_bytes: float,
                    activation_bytes: float) -> List[Tuple[str, float, str]]:
    """The plan's collective schedule (shared by ``price_train_step`` and
    the columnar ``enumerate_plans``):
      * FSDP all-gather of params (per microbatch, fwd + bwd if remat=full)
      * reduce-scatter of grads over data axes (+ pod axis)
      * TP activation all-reduces: ~2 per layer-equivalent, approximated as
        activation_bytes/tp_degree volume when tp>1.
    """
    mesh = plan.mesh
    chips = mesh.num_devices
    data_axes = [a for a, _ in mesh.axes if a in ("data", "pod")]
    ops: List[Tuple[str, float, str]] = []
    shard_param_bytes = param_bytes / chips
    for axis in data_axes:
        # FSDP gather once per microbatch fwd; bwd regather if remat=full
        gathers = plan.microbatches * (2 if plan.remat == "full" else 1)
        ops.append(("all-gather", shard_param_bytes * gathers, axis))
    grad_bytes = param_bytes / chips
    if plan.compressed_grads:
        grad_bytes *= 0.25           # int8 wire format vs fp32 master grads
    for axis in data_axes:
        ops.append(("reduce-scatter", grad_bytes, axis))
        ops.append(("all-gather", grad_bytes, axis))
    if plan.tp_degree > 1:
        # activation all-reduces on the model axis
        ops.append(("all-reduce",
                    activation_bytes / chips / max(plan.microbatches, 1),
                    "model"))
    return ops


def _step_total(t_compute: float, t_memory: float, t_exposed: float,
                alpha: float, hw: HardwareParams) -> float:
    """Step-time roofline: overlapped max + exposed remainder + launch."""
    t_step = max(t_compute, (1 - alpha) * t_memory, t_exposed) \
        + min(t_compute, (1 - alpha) * t_memory)
    return t_step + hw.launch_latency_s


def price_train_step(plan: PlanCandidate, *,
                     model_flops: float,          # 6*N*D useful flops (global)
                     param_bytes: float,          # total param bytes (global)
                     activation_bytes: float,     # per-step act traffic (global)
                     hw: HardwareParams = TPU_V5E) -> StepCost:
    """Price one training step under a plan (collective schedule per
    ``_collective_ops``)."""
    chips = plan.mesh.num_devices

    remat_f = REMAT_FLOP_FACTOR[plan.remat]
    flops_per_chip = model_flops * remat_f / chips
    t_compute = flops_per_chip / hw.sustained_flops("bf16", matrix=True)

    # HBM traffic per chip: params touched fwd+bwd+opt (3x) + activations
    act_factor = _REMAT_ACT_FACTOR[plan.remat]
    hbm_bytes = (3.0 * param_bytes / chips
                 + activation_bytes * act_factor / chips)
    t_memory = hbm_bytes / hw.hbm_sustained_bw

    ops = _collective_ops(plan, param_bytes=param_bytes,
                          activation_bytes=activation_bytes)
    alpha = hw.pipeline_overlap_alpha
    sched = coll.schedule_time(ops, plan.mesh, hw, overlap_alpha=alpha)
    t_coll, t_exposed = sched["total"], sched["exposed"]

    total = _step_total(t_compute, t_memory, t_exposed, alpha, hw)
    return StepCost(plan=plan, compute_s=t_compute, memory_s=t_memory,
                    collective_s=t_coll, exposed_collective_s=t_exposed,
                    total_s=total, hbm_bytes_per_chip=hbm_bytes,
                    detail={k: v for k, v in sched.items()
                            if k not in ("total", "exposed")})


def hbm_fits(plan: PlanCandidate, *, param_bytes: float,
             opt_state_bytes: float, activation_peak_bytes: float,
             hw: HardwareParams = TPU_V5E) -> bool:
    chips = plan.mesh.num_devices
    act_factor = {"none": 1.0, "block": 0.4, "full": 0.15}[plan.remat]
    per_chip = ((param_bytes + opt_state_bytes) / chips
                + activation_peak_bytes * act_factor
                / chips * plan.microbatches ** 0  # act peak per microbatch
                / max(plan.microbatches, 1))
    return per_chip <= hw.hbm_capacity * 0.9


_REMAT_ACT_FACTOR = {"none": 1.0, "block": 0.6, "full": 0.35}
_REMAT_PEAK_FACTOR = {"none": 1.0, "block": 0.4, "full": 0.15}


#: below this many plans per worker a process pool costs more than the
#: collective-schedule Python it parallelizes (~tens of us per plan).
_MIN_PLANS_PER_WORKER = 64


def _price_plan_block(candidates: Sequence[PlanCandidate],
                      opt_b: np.ndarray, model_flops: float,
                      param_bytes: float, activation_bytes: float,
                      activation_peak_bytes: float,
                      hw: HardwareParams) -> List[StepCost]:
    """One columnar pricing block (the chunk unit of ``enumerate_plans``;
    matches ``price_train_step`` expression-for-expression)."""
    chips = np.array([p.mesh.num_devices for p in candidates],
                     dtype=np.float64)
    ubatch = np.array([p.microbatches for p in candidates], dtype=np.float64)
    remat_f = np.array([REMAT_FLOP_FACTOR[p.remat] for p in candidates])
    act_f = np.array([_REMAT_ACT_FACTOR[p.remat] for p in candidates])
    peak_f = np.array([_REMAT_PEAK_FACTOR[p.remat] for p in candidates])

    flops_per_chip = model_flops * remat_f / chips
    t_compute = flops_per_chip / hw.sustained_flops("bf16", matrix=True)
    hbm_bytes = (3.0 * param_bytes / chips
                 + activation_bytes * act_f / chips)
    t_memory = hbm_bytes / hw.hbm_sustained_bw
    alpha = hw.pipeline_overlap_alpha

    # HBM-fit gate (mirrors hbm_fits per element)
    per_chip = ((param_bytes + opt_b) / chips
                + activation_peak_bytes * peak_f
                / chips / np.maximum(ubatch, 1))
    feasible = per_chip <= hw.hbm_capacity * 0.9

    costs = []
    for i, plan in enumerate(candidates):
        ops = _collective_ops(plan, param_bytes=param_bytes,
                              activation_bytes=activation_bytes)
        sched = coll.schedule_time(ops, plan.mesh, hw, overlap_alpha=alpha)
        t_coll, t_exposed = sched["total"], sched["exposed"]
        t_c, t_m = float(t_compute[i]), float(t_memory[i])
        detail = {k: v for k, v in sched.items()
                  if k not in ("total", "exposed")}
        detail["feasible"] = 1.0 if feasible[i] else 0.0
        costs.append(StepCost(
            plan=plan, compute_s=t_c, memory_s=t_m, collective_s=t_coll,
            exposed_collective_s=t_exposed,
            total_s=_step_total(t_c, t_m, t_exposed, alpha, hw),
            hbm_bytes_per_chip=float(hbm_bytes[i]), detail=detail))
    return costs


def _plan_shard(candidates, opt_b, model_flops, param_bytes,
                activation_bytes, activation_peak_bytes, hw, chunk_size):
    """Worker body for jobs-sharded ``enumerate_plans`` (top-level so it
    pickles under spawn as well as fork)."""
    return enumerate_plans(
        candidates, model_flops=model_flops, param_bytes=param_bytes,
        activation_bytes=activation_bytes, opt_state_bytes=opt_b,
        activation_peak_bytes=activation_peak_bytes, hw=hw,
        chunk_size=chunk_size)


def enumerate_plans(candidates: Sequence[PlanCandidate], *,
                    model_flops: float, param_bytes: float,
                    activation_bytes: float,
                    opt_state_bytes: Union[float, Sequence[float]] = 0.0,
                    activation_peak_bytes: float = 0.0,
                    hw: HardwareParams = TPU_V5E,
                    chunk_size: Optional[int] = None,
                    jobs=None) -> List[StepCost]:
    """Price every candidate plan (collective schedule + HBM-fit gate).

    This is the enumeration half of the paper's argmin: callers that only
    need the winner use ``select_plan``; hillclimb-style consumers read the
    whole priced list to order their experiments.

    The arithmetic runs columnar over the candidate set (one NumPy block
    per ``chunk_size`` plans, matching ``price_train_step``
    expression-for-expression); only the per-plan collective schedule walks
    Python.  ``opt_state_bytes`` may be a per-plan sequence (e.g. int8 vs
    fp32 optimizer moments) so heterogeneous what-if screens price in a
    single call.

    ``chunk_size`` bounds the NumPy intermediates for very large candidate
    sets; ``jobs`` (0/"auto" = ``os.cpu_count()``) shards the candidate
    list across worker processes when the set is large enough to amortize
    the pool (results are concatenated in candidate order, identical to a
    serial run).
    """
    n = len(candidates)
    if not n:
        return []
    opt_b = np.full(n, opt_state_bytes, dtype=np.float64) \
        if np.isscalar(opt_state_bytes) \
        else np.asarray(opt_state_bytes, dtype=np.float64)
    if opt_b.shape != (n,):
        raise ValueError(f"opt_state_bytes: expected scalar or {n} values")

    if jobs is not None:
        from . import parallel, sweep
        njobs = sweep.effective_jobs(jobs)
        if njobs > 1 and n >= _MIN_PLANS_PER_WORKER * njobs:
            bounds = [(n * j // njobs, n * (j + 1) // njobs)
                      for j in range(njobs)]
            shards = parallel.map_jobs(
                _plan_shard,
                [(list(candidates[lo:hi]), opt_b[lo:hi], model_flops,
                  param_bytes, activation_bytes, activation_peak_bytes,
                  hw, chunk_size) for lo, hi in bounds if hi > lo],
                jobs=njobs)
            return [c for shard in shards for c in shard]

    size = int(chunk_size) if chunk_size else n
    costs: List[StepCost] = []
    for lo in range(0, n, max(size, 1)):
        hi = min(lo + size, n)
        costs.extend(_price_plan_block(
            list(candidates[lo:hi]), opt_b[lo:hi], model_flops,
            param_bytes, activation_bytes, activation_peak_bytes, hw))
    return costs


def select_plan(candidates: Sequence[PlanCandidate], *,
                model_flops: float, param_bytes: float,
                activation_bytes: float,
                opt_state_bytes: float = 0.0,
                activation_peak_bytes: float = 0.0,
                hw: HardwareParams = TPU_V5E
                ) -> Tuple[StepCost, List[StepCost]]:
    """Price all candidates; return (best, all) — paper's argmin, with an
    HBM-fit feasibility gate (the paper's 'proves it fits')."""
    costs = enumerate_plans(
        candidates, model_flops=model_flops, param_bytes=param_bytes,
        activation_bytes=activation_bytes, opt_state_bytes=opt_state_bytes,
        activation_peak_bytes=activation_peak_bytes, hw=hw)
    feas = [c for c in costs if c.detail.get("feasible", 1.0) > 0]
    pool = feas or costs
    best = min(pool, key=lambda c: c.total_s)
    return best, costs


# ---------------------------------------------------------------------------
# Columnar kernel-level sweeps (paper §IV-B adaptive tile selection, served
# by the table path so 10^3-10^4-point searches never instantiate
# per-config Workload objects).
# ---------------------------------------------------------------------------

def _tile_totals(base: Workload, hw: HardwareParams,
                 candidate_tiles: Sequence["TileConfig"], *,
                 model: Optional[str], engine, chunk_size, jobs
                 ) -> np.ndarray:
    """Totals column for a tile lattice: the memoized whole-table path by
    default, the streaming/sharded path when ``chunk_size``/``jobs`` ask
    for bounded memory or multi-core pricing (same floats either way)."""
    from . import sweep
    if chunk_size is None and jobs is None:
        table = WorkloadTable.tile_lattice(base, candidate_tiles)
        return sweep.predict_table(table, hw, model=model,
                                   engine=engine).totals
    spec = LatticeSpec.tile_lattice(base, candidate_tiles)
    return sweep.predict_totals_stream(spec, hw, model=model,
                                       engine=engine,
                                       chunk_size=chunk_size, jobs=jobs)


def enumerate_tiles(base: Workload, hw: HardwareParams,
                    candidate_tiles: Sequence["TileConfig"], *,
                    model: Optional[str] = None,
                    engine=None, chunk_size: Optional[int] = None,
                    jobs=None) -> Dict[str, float]:
    """Price ``base`` re-tiled with every candidate through the columnar
    table path; returns {"bMxbNxbK": seconds}."""
    totals = _tile_totals(base, hw, candidate_tiles, model=model,
                          engine=engine, chunk_size=chunk_size, jobs=jobs)
    return {f"{t.bm}x{t.bn}x{t.bk}": float(s)
            for t, s in zip(candidate_tiles, totals)}


def select_tile(base: Workload, hw: HardwareParams,
                candidate_tiles: Sequence["TileConfig"], *,
                model: Optional[str] = None,
                engine=None, chunk_size: Optional[int] = None,
                jobs=None) -> Tuple["TileConfig", Dict[str, float]]:
    """Fused argmin over candidate tiles (the paper's adaptive tile
    selection): one columnar sweep, one reduction on the totals column.
    With ``chunk_size``/``jobs`` the lattice streams in O(chunk) memory
    and/or shards across cores — winner identical either way."""
    totals = _tile_totals(base, hw, candidate_tiles, model=model,
                          engine=engine, chunk_size=chunk_size, jobs=jobs)
    best_i = int(np.argmin(totals))
    costs = {f"{t.bm}x{t.bn}x{t.bk}": float(s)
             for t, s in zip(candidate_tiles, totals)}
    return candidate_tiles[best_i], costs
