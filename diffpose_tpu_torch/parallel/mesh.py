"""The process group and the rank grid: one process per rank, ``torch.distributed``.

Counterpart of ``diffpose_tpu/parallel/mesh.py``.  There one process drives
every device of a host and a ``jax.sharding.Mesh`` names their axes; here
each rank is a process of its own (``torchrun`` or a spawned worker), and a
``DeviceMesh`` (``torch.distributed.device_mesh.init_device_mesh``) lays the
ranks out on named axes: ``data``, and optionally ``hypothesis`` (the frame
and implicit evals) or ``context`` (the video family's frames).  Each axis
has its process group (``mesh.get_group(name)``) and each rank its coordinate
on it (:func:`mesh_axis`): the counterparts of an axis name inside
``shard_map`` and of ``jax.lax.axis_index``.

Backends: ``nccl`` for CUDA tensors, ``gloo`` for CPU tensors.  A caller may
also run ``gloo`` over CUDA tensors, several ranks on one card (the one-card
test of a two-rank world); every collective of this package is an
``all_reduce`` or a ``barrier``, which ``gloo`` takes on either device.
"""

from __future__ import annotations

import math
import os
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# What a launcher (torchrun) sets; with none of them the job is one process.
ENV_KEYS = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")


def distributed_init(backend: Optional[str] = None, *, device="cuda") -> Tuple[int, int]:
    """Join (or start) the process group; returns ``(rank, world_size)``.

    Reads ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
    ``MASTER_PORT`` as ``torchrun`` sets them.  With none set it is a single
    process of world size 1, whose group lives in an in-process store (no
    port is opened), as a one-chip JAX job needs no coordinator.  A group
    that exists already is returned as it is.

    ``device``: where this rank computes.  ``"cuda"`` puts it on
    ``cuda:LOCAL_RANK`` (``torch.cuda.set_device``); ``"cuda:i"`` on card
    ``i`` whatever the rank, which is how several ranks share one card.
    ``backend`` (``nccl`` for a CUDA device, ``gloo`` for the CPU by
    default) takes the place of the JAX call's ``cpu_collectives``.
    """
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"device {device!r}: torch.cuda.is_available() is False; pass "
                               "device='cpu' for a CPU run (gloo)")
        torch.cuda.set_device(dev.index if dev.index is not None
                              else int(os.environ.get("LOCAL_RANK", 0)))
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if not any(k in os.environ for k in ENV_KEYS):
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    else:
        missing = [k for k in ("RANK", "WORLD_SIZE", "MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if missing:
            raise RuntimeError(f"a multi-process launch sets {ENV_KEYS}; missing {missing}")
        dist.init_process_group(backend, init_method="env://")
    return dist.get_rank(), dist.get_world_size()


def distributed_shutdown():
    """Leave the process group, if there is one."""
    if dist.is_initialized():
        dist.destroy_process_group()


def make_mesh(axis_sizes: Optional[Sequence[int]] = None,
              axis_names: Sequence[str] = ("data",), *, device_type: str = "cuda"):
    """A ``DeviceMesh`` over the world's ranks (:func:`distributed_init`
    first).

    Default: a 1-D ``('data',)`` mesh over every rank.  Pass e.g.
    ``axis_sizes=(2, 2), axis_names=('data', 'hypothesis')`` for a 2-D grid:
    rank ``r`` sits at ``(r // 2, r % 2)``.  ``device_type`` is ``"cuda"`` or
    ``"cpu"``, where the ranks compute.
    """
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    sizes = tuple(int(s) for s in axis_sizes) if axis_sizes is not None else (world,)
    assert math.prod(sizes) == world, f"mesh {sizes} != {world} ranks"
    return init_device_mesh(device_type, sizes, mesh_dim_names=tuple(axis_names))


class MeshAxis(NamedTuple):
    """One axis of a mesh seen from this rank: its group, this rank's
    coordinate on it and its size.  An axis the mesh does not have is the
    trivial one (no group, coordinate 0, size 1)."""

    name: str
    group: Optional[dist.ProcessGroup]
    index: int
    size: int


def mesh_axis(mesh, name: str) -> MeshAxis:
    """``mesh``'s axis ``name`` as a :class:`MeshAxis`."""
    if mesh is None or name not in (mesh.mesh_dim_names or ()):
        return MeshAxis(name, None, 0, 1)
    dim = mesh.mesh_dim_names.index(name)
    return MeshAxis(name, mesh.get_group(name), mesh.get_local_rank(name), mesh.size(dim))


def is_main_rank() -> bool:
    """Rank 0 of the world, or a job without a process group: the rank that
    writes logs and checkpoints."""
    return not dist.is_initialized() or dist.get_rank() == 0


def barrier():
    if dist.is_initialized():
        dist.barrier()
