"""Collective-byte accounting for the roofline's third term: the sum of the
operand sizes of every all-gather / all-reduce / reduce-scatter /
all-to-all / collective-permute that one step issues on one rank.

Counterpart of ``repro/launch/hlo_analysis.py``.  The reference parses the
compiled HLO text; a PyTorch step has no HLO, so what replaces it is the
step itself, traced on one rank of a (fake) process group
(``launch/dryrun.py``): every c10d collective the step issues passes
through ``CollectiveCounter.record`` with its operands.  It sees both kinds
the port issues:

  * the functional ones (``_c10d_functional.*``) of DTensor's
    redistributions, where a placement changes;
  * the in-place ``torch.distributed`` calls (``c10d.allreduce_``,
    ``c10d.allgather_``, ...) of the per-rank regions
    (``distributed.sharding.reduce_from`` / ``gather_from``, used by
    ``models.moe.moe_apply_sharded`` and ``models.ssm.ssd_apply_shard_map``).

Names map onto the reference's five: ``all_reduce`` -> all-reduce,
``all_gather_into_tensor`` -> all-gather, ``reduce_scatter_tensor`` ->
reduce-scatter, ``all_to_all_single`` -> all-to-all, a ``send`` (the half
of a send/recv pair that carries the operand) -> collective-permute.  The
waits, ``_wrap_tensor_autograd`` and the ``recv`` halves are not
collectives of their own and are skipped.  Bytes are the operands' on this
rank, as the reference counts them (operand shapes, else the result's).

The reference's while-loop trip counts and its dynamic-update-slice
over-count have no meaning here: an eager trace runs every layer (each
collective is seen as often as it is issued) and charges an in-place cache
write at its slice.  So neither is kept.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import torch
from torch.utils import _pytree as pytree
from torch.utils._python_dispatch import TorchDispatchMode

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")

# op name (without namespace or overload) -> (reference name, the index of
# the operand argument)
_OPS = {
    # functional (DTensor's redistributions)
    "all_reduce": ("all-reduce", 0),
    "all_reduce_": ("all-reduce", 0),
    "all_reduce_coalesced": ("all-reduce", 0),
    "all_reduce_coalesced_": ("all-reduce", 0),
    "all_gather_into_tensor": ("all-gather", 0),
    "all_gather_into_tensor_out": ("all-gather", 0),
    "all_gather_into_tensor_coalesced": ("all-gather", 0),
    "reduce_scatter_tensor": ("reduce-scatter", 0),
    "reduce_scatter_tensor_coalesced": ("reduce-scatter", 0),
    "all_to_all_single": ("all-to-all", 0),
    "shard_dim_alltoall": ("all-to-all", 0),     # DTensor's Shard -> Shard
    # in-place c10d (torch.distributed.all_reduce & co.)
    "allreduce_": ("all-reduce", 0),
    "allreduce_coalesced_": ("all-reduce", 0),
    "allgather_": ("all-gather", 1),
    "_allgather_base_": ("all-gather", 1),
    "allgather_coalesced_": ("all-gather", 1),
    "allgather_into_tensor_coalesced_": ("all-gather", 1),
    "reduce_scatter_": ("reduce-scatter", 1),
    "_reduce_scatter_base_": ("reduce-scatter", 1),
    "reduce_scatter_tensor_coalesced_": ("reduce-scatter", 1),
    "alltoall_": ("all-to-all", 1),
    "alltoall_base_": ("all-to-all", 1),
    "send": ("collective-permute", 0),
}
_NAMESPACES = ("_c10d_functional", "_c10d_functional_autograd", "c10d",
               "_dtensor")


def _nbytes(tree) -> float:
    return float(sum(t.numel() * t.element_size()
                     for t in pytree.tree_leaves(tree)
                     if isinstance(t, torch.Tensor)))


def group_axes(mesh) -> Dict[str, Tuple[str, ...]]:
    """{process group name: the mesh axes it spans} for ``mesh`` (a
    DeviceMesh), the whole world spanning every axis."""
    if mesh is None:
        return {}
    from torch import distributed as dist
    names = tuple(mesh.mesh_dim_names)
    out = {mesh.get_group(a).group_name: (a,) for a in names}
    if dist.is_initialized():
        out.setdefault(dist.group.WORLD.group_name, names)
    return out


@dataclass
class CollectiveStats:
    """Per-op-type byte totals and the schedule, one row per collective in
    issue order: (op, operand bytes, the mesh axes its group spans)."""

    totals: Dict[str, float] = field(default_factory=dict)
    schedule: List[Tuple[str, float, Tuple[str, ...]]] = field(
        default_factory=list)

    @property
    def total_bytes(self) -> float:
        return sum(self.totals.values())


def analyze(records) -> CollectiveStats:
    """Sum recorded collectives ((op, bytes, axes) rows, e.g.
    ``CollectiveCounter.records``) per op type."""
    stats = CollectiveStats()
    for op, nbytes, axes in records:
        stats.totals[op] = stats.totals.get(op, 0.0) + nbytes
        stats.schedule.append((op, nbytes, axes))
    return stats


class CollectiveCounter(TorchDispatchMode):
    """Records every collective it sees as (op, operand bytes on this rank,
    axes).  As a dispatch mode it sees the collectives issued on plain
    tensors (an explicit ``DTensor.redistribute``, a per-rank region); the
    dry run's trace also hands it the ones DTensor issues inside an op
    (``record``).  ``mesh`` names the axes of its groups (None: unnamed)."""

    def __init__(self, mesh=None):
        super().__init__()
        self.records: List[Tuple[str, float, Tuple[str, ...]]] = []
        self._axes = group_axes(mesh)

    def _axes_of(self, args) -> Optional[Tuple[str, ...]]:
        for a in pytree.tree_leaves(args):
            if isinstance(a, torch.ScriptObject):     # c10d's in-place ops
                from torch import distributed as dist
                a = dist.ProcessGroup.unbox(a)
            name = a if isinstance(a, str) else getattr(a, "group_name",
                                                        None)
            if name in self._axes:
                return self._axes[name]
        return None

    def record(self, func, args, kwargs) -> bool:
        """Record ``func(*args, **kwargs)`` if it is a collective; True if
        it was."""
        if func.namespace not in _NAMESPACES:
            return False
        hit = _OPS.get(func._opname)
        if hit is None:
            return False
        op, i = hit
        operand = args[i] if len(args) > i else None
        nbytes = _nbytes(operand)
        if nbytes == 0.0:
            nbytes = _nbytes(args[0]) if args else 0.0
        self.records.append((op, nbytes, self._axes_of((args, kwargs))))
        return True

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        self.record(func, args, kwargs)
        return func(*args, **kwargs)

    def stats(self) -> CollectiveStats:
        return analyze(self.records)


def summarize(stats: CollectiveStats) -> str:
    lines = [f"collective bytes total: {stats.total_bytes:.3e}"]
    for op, b in sorted(stats.totals.items()):
        lines.append(f"  {op:20s} {b:.3e}")
    return "\n".join(lines)
