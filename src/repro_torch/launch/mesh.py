"""Mesh construction over an initialised process group.

Counterpart of ``repro/launch/mesh.py``.  A function (not a module-level
constant), so importing this module never touches a process group or a
device.  Production target: pods of 256 ranks as a 16x16 (data, model)
mesh; multi-pod adds a leading "pod" axis.  Each function takes the ranks
of ``torch.distributed``'s default process group, which the caller has
initialised (``init_process_group`` with its address, world size and rank):
gloo over CPU processes in the tests; on one card, ranks that share it over
gloo (NCCL refuses two ranks on one GPU); for the dry run, the fake world of
``fake_world``, which stands in for the reference's 512 placeholder devices.
"""
from __future__ import annotations

import contextlib
import math

from torch import distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ..device import DeviceLike, resolve_device


# NVLink 4 of the H100 SXM: 900 GB/s a card, both directions together (the
# data sheet); the h100 file carries no link rate.  One rate prices every
# link: the dry run's collective term and ``core/collectives``' price of the
# sharded paths' bytes.
NVLINK_BYTES_PER_S_ONE_WAY = 450e9


@contextlib.contextmanager
def fake_world(n: int):
    """A fake process group of ``n`` ranks (no transport: a collective
    returns at once with its output's shape), joined as rank 0, closed
    again on exit, so that one process can open 256 ranks and then 512."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _world() -> int:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call torch.distributed."
                           "init_process_group first")
    return dist.get_world_size()


def make_production_mesh(*, multi_pod: bool = False,
                         device: DeviceLike = None) -> DeviceMesh:
    """(data 16, model 16), or (pod 2, data 16, model 16) with
    ``multi_pod``, over exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    world = _world()
    if world != n:
        raise RuntimeError(f"need a world of {n} ranks for mesh {shape}; "
                           f"have {world}")
    return init_device_mesh(resolve_device(device).type, shape,
                            mesh_dim_names=axes)


def make_test_mesh(*, devices: int = 0, model: int = 2, pod: int = 1,
                   device: DeviceLike = None) -> DeviceMesh:
    """Small (data, model) mesh, or (pod, data, model) with ``pod`` > 1,
    over ``devices`` ranks (default: the whole world)."""
    n = devices or _world()
    data = n // (model * pod)
    dev = resolve_device(device).type
    if pod > 1:
        return init_device_mesh(dev, (pod, data, model),
                                mesh_dim_names=("pod", "data", "model"))
    return init_device_mesh(dev, (data, model),
                            mesh_dim_names=("data", "model"))


def mesh_spec_of(mesh):
    """core.collectives.MeshSpec view of a mesh (a DeviceMesh, or a
    mapping of axis name to size), for the analytical collective model."""
    from ..core.collectives import MeshSpec
    from ..distributed.sharding import mesh_shape
    return MeshSpec(axes=tuple(mesh_shape(mesh).items()))
