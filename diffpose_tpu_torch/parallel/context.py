"""Context parallelism: the video window's frame axis sharded over ranks.

Counterpart of ``diffpose_tpu/parallel/context.py``.  The joint graph is
small (17 joints); the long axis is the window (81 or 243 frames).  Over a
``context`` mesh axis each rank holds a contiguous block of every window's
frames: the spatial blocks act on one frame at a time and need nothing from
the other ranks, and the temporal attention keeps its queries on the rank
and gathers the keys and values of the whole window (:func:`gather_frames`,
the counterpart of the ``all_gather`` in ``diffpose_tpu/models/video.py:76-79``),
so the attention is exact.

The gather is an ``all_reduce`` (each rank writes its block into a zero
buffer of the whole window), the one collective that ``gloo`` and ``nccl``
both take on CUDA and CPU tensors (``parallel/sharding.py``).  Its backward
is one ``all_reduce`` of the incoming gradient, then this rank's block:
every rank's queries read every key, and the loss is a sum over the ranks'
frames, so the gradient of a rank's keys and values is the sum of what
every rank's attention sends back.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from diffpose_tpu_torch.parallel.mesh import MeshAxis, mesh_axis


class _GatherFrames(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int, group, index: int, size: int):
        f = x.shape[dim]
        shape = list(x.shape)
        shape[dim] = f * size
        buf = x.new_zeros(shape)
        buf.narrow(dim, index * f, f).copy_(x)
        dist.all_reduce(buf, group=group)
        ctx.block = (dim, group, index, f)
        return buf

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        dim, group, index, f = ctx.block
        grad = grad.contiguous().clone()      # all_reduce writes in place; autograd owns grad
        dist.all_reduce(grad, group=group)
        return grad.narrow(dim, index * f, f), None, None, None, None


def gather_frames(x: torch.Tensor, axis: Optional[MeshAxis], dim: int = 1) -> torch.Tensor:
    """Every rank's block of ``axis`` (``F_local`` frames along ``dim``), in
    coordinate order: ``F_local·size`` frames along ``dim``, differentiable
    (the module's docstring).  ``x`` itself where the axis has no group.
    The temporal blocks gather keys and values side by side, ``[n, F_local,
    2·d]`` rows, one collective a layer."""
    if axis is None or axis.group is None:
        return x
    return _GatherFrames.apply(x, dim, axis.group, axis.index, axis.size)


def make_cp_video_forward(model, mesh, *, cp_axis: str = "context", mask=None):
    """Bind ``model`` (a ``SpatioTemporalDiff`` built with ``cp_axis``) to
    ``mesh`` and return ``fn(x_local, t) → ε̂_local``: the forward of this
    rank's frame block ``[B, F / size, J, C]`` of every window, the
    positional rows of that block and the keys and values gathered over the
    axis inside each temporal block.  Counterpart of
    ``diffpose_tpu/parallel/context.py:make_cp_video_forward``, whose caller
    passes the whole window to a ``shard_map``; here every rank is a process
    and passes its own block."""
    if model.cp_axis != cp_axis:
        raise ValueError(f"the model was built with cp_axis={model.cp_axis!r}, not {cp_axis!r}")
    model.bind_mesh(mesh)

    def fn(x_local: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
        return model(x_local, t, mask)

    fn.axis = mesh_axis(mesh, cp_axis)
    return fn
