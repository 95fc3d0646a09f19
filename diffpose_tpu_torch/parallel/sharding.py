"""Sharded train and eval steps: one rank a shard, ``all_reduce`` over the mesh's groups.

Counterpart of ``diffpose_tpu/parallel/sharding.py``.  There ``shard_map``
runs one step per device over its slice of a global batch and ``pmean`` /
``psum`` reduce over a mesh axis; here every rank is a process that holds
its slice (:func:`shard_batch`, or a ``BatchLoader`` keyed by the data
coordinate) and runs the single-process step of ``train/steps.py`` or
``train/implicit_steps.py`` with that axis's :class:`MeshAxis`:

* training: parameters, optimizer state and EMA shadow are replicated (every
  rank starts from the same and applies the same update); each rank draws
  from the step's generator folded with its data coordinate (:func:`fold_in`,
  ``jax.random.fold_in``), computes its gradient, and one flat ``all_reduce``
  a step averages the gradients (:func:`all_reduce_mean_grads`) before the
  clip and the optimizer see them; the loss is averaged too.  The fused
  steps run the kernels (rows 1-2, 3, 5-8) on each rank's own slice;
* evaluation: frames shard over ``data``; hypotheses stay on the rank or,
  over a ``hypothesis`` axis, shard too and their mean is a sum over that
  group.  Per-sample P1/P2 come back as this rank's slice; the runner
  gathers them (:func:`gather_rows`).

A mean of per-rank means is the global mean only for equal shards, so every
shard is a batch's equal part (``batch % data size == 0``).  Every
collective is an ``all_reduce`` (a gather is one over a zero-filled buffer):
the one collective that both ``nccl`` and ``gloo`` take on CUDA and CPU
tensors alike.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from diffpose_tpu_torch.parallel.mesh import MeshAxis, mesh_axis

_MASK63 = (1 << 63) - 1


class Shard(NamedTuple):
    """Which equal part of an array's leading axis this rank holds."""

    index: int
    count: int

    def rows(self, n: int) -> slice:
        assert n % self.count == 0, f"{n} rows do not split into {self.count} equal shards"
        k = n // self.count
        return slice(self.index * k, (self.index + 1) * k)


def replicated(mesh) -> Shard:
    """The whole array on every rank."""
    return Shard(0, 1)


def data_sharding(mesh, axis: str = "data") -> Shard:
    """This rank's part of an array whose leading axis shards over ``axis``."""
    a = mesh_axis(mesh, axis)
    return Shard(a.index, a.size)


def shard_batch(mesh, batch: dict, axis: str = "data", device=None) -> dict:
    """This rank's contiguous slice of a global host batch (numpy arrays or
    tensors), each value on ``device`` when one is given."""
    shard = data_sharding(mesh, axis)
    out = {}
    for k, v in batch.items():
        part = v[shard.rows(v.shape[0])]
        if device is not None:
            part = torch.as_tensor(np.ascontiguousarray(part) if isinstance(part, np.ndarray)
                                   else part, device=device)
        out[k] = part
    return out


# ----------------------------------------------------------------------
# collectives
# ----------------------------------------------------------------------

def all_reduce_mean_grads(params, axis: MeshAxis, *extra: torch.Tensor,
                          divisor: Optional[int] = None):
    """Average every parameter's ``.grad`` over ``axis``, and the float32
    tensors ``extra`` with them, in one flat ``all_reduce``.  The gradients
    are written back into their own tensors (a parameter without one counts
    as zeros); returns the averaged ``extra`` as new tensors.  ``divisor``
    replaces the axis's size: the video step over a data x context mesh
    sums over context and averages over data, dividing the sum over both by
    the data size."""
    if axis.group is None:
        return extra
    params = [p for p in params if p.requires_grad]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [p.grad for p in params]
    parts = grads + [e.detach() for e in extra]
    flat = torch.cat([t.reshape(-1) for t in parts])
    dist.all_reduce(flat, group=axis.group)
    flat.div_(axis.size if divisor is None else divisor)
    views = [v.view_as(t) for v, t in zip(flat.split([t.numel() for t in parts]), parts)]
    torch._foreach_copy_(grads, views[:len(grads)])
    return tuple(views[len(grads):])


def joint_axis(*axes: Optional[MeshAxis]) -> MeshAxis:
    """The ranks that ``axes`` span together, as one axis: the axis itself
    where only one has a group, the world where several do (``make_mesh``
    lays its axes over the whole world), the trivial axis where none does."""
    live = [a for a in axes if a is not None and a.group is not None]
    if len(live) <= 1:
        return live[0] if live else MeshAxis("", None, 0, 1)
    size = math.prod(a.size for a in live)
    if size != dist.get_world_size():
        raise ValueError(f"axes {[a.name for a in live]} span {size} of "
                         f"{dist.get_world_size()} ranks; a joint reduction needs the world")
    return MeshAxis("+".join(a.name for a in live), dist.group.WORLD, dist.get_rank(), size)


def mean_over(t: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """The mean of ``t`` over ``axis`` (a new tensor)."""
    if axis.group is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=axis.group)
    return t.div_(axis.size)


def sum_over(t: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """The sum of ``t`` over ``axis`` (a new tensor)."""
    if axis.group is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=axis.group)
    return t


def max_over(t: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """The maximum of ``t`` over ``axis`` (a new tensor)."""
    if axis.group is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=axis.group)
    return t


def gather_rows(t: torch.Tensor, axis: MeshAxis) -> torch.Tensor:
    """Every rank's ``t`` of ``axis``, stacked by coordinate along the
    leading axis: an ``all_reduce`` of a zero buffer that holds ``t`` in this
    rank's place (exact, and on any backend and device)."""
    if axis.group is None:
        return t
    buf = t.new_zeros((axis.size, *t.shape))
    buf[axis.index] = t
    dist.all_reduce(buf, group=axis.group)
    return buf.reshape(axis.size * t.shape[0], *t.shape[1:]) if t.dim() else buf


def fold_in(generator: torch.Generator, index: int) -> torch.Generator:
    """A generator for coordinate ``index``, made from one step of
    ``generator`` (the counterpart of ``jax.random.fold_in(key, index)``).

    Every rank passes a generator in the same state, which each call
    advances the same way, so ranks with equal ``index`` draw alike and
    others differently.  A CUDA generator keeps its state on the host: its
    seed and Philox offset are read and the offset advanced without waiting
    for the card."""
    if generator.device.type == "cuda":
        offset = generator.get_offset()
        generator.set_offset(offset + 4)
        base = generator.initial_seed() * 0x9E3779B97F4A7C15 + offset
    else:
        base = int(torch.randint(0, 1 << 62, (1,), generator=generator))
    z = (base ^ ((index + 1) * 0xBF58476D1CE4E5B9)) & ((1 << 64) - 1)   # splitmix64 finalizer
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & ((1 << 64) - 1)
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & ((1 << 64) - 1)
    return torch.Generator(device=generator.device).manual_seed((z ^ (z >> 31)) & _MASK63)


# ----------------------------------------------------------------------
# the frame family
# ----------------------------------------------------------------------

def make_sharded_train_step(model, optimizer, betas, mesh, *, axis: str = "data",
                            impl: str = "fused", ema_mu: Optional[float] = 0.999,
                            device="cuda", dropout: str = "masks",
                            tier: str = "bf16x3") -> Callable:
    """The data-parallel train step: ``step(state, batch, generator) →
    (state, metrics)`` with ``batch`` this rank's slice of the global batch.

    The step of ``train/steps.py:make_train_step`` over ``axis``: draws folded
    with this rank's coordinate on ``axis``, gradients and loss averaged over
    it before the clip.  Ranks of one ``axis`` coordinate (a 2-D mesh's
    ``hypothesis`` replicas) compute the same step.  ``step.draw`` /
    ``step.apply`` are exposed as on the single-process step."""
    from diffpose_tpu_torch.train.steps import make_train_step

    return make_train_step(model, optimizer, betas, impl=impl, ema_mu=ema_mu, device=device,
                           dropout=dropout, axis=mesh_axis(mesh, axis), tier=tier)


def _local_columns(idx: torch.Tensor, shard: Shard) -> torch.Tensor:
    return idx[:, shard.rows(idx.shape[1])]


def make_sharded_train_sweep_step(model, optimizer, betas, mesh, *, sweep: int,
                                  axis: str = "data", impl: str = "fused",
                                  ema_mu: Optional[float] = 0.999, device="cuda",
                                  dropout: str = "masks",
                                  base_step: Optional[Callable] = None,
                                  tier: str = "bf16x3") -> Callable:
    """Device-resident-data training over the mesh: ``sweep_step(state, data,
    idx, generator) → (state, {"loss": [sweep]})``.

    ``data`` is the whole train set, replicated on every rank's device;
    ``idx`` the global ``[sweep, B]`` index array, of which each rank takes
    its columns ``idx[:, d·B/D:(d+1)·B/D]`` (``d`` its data coordinate).  The
    same as ``sweep`` calls of :func:`make_sharded_train_step` on those
    batches with one generator."""
    from diffpose_tpu_torch.train.steps import make_train_sweep_step

    base = base_step or make_sharded_train_step(model, optimizer, betas, mesh, axis=axis,
                                                impl=impl, ema_mu=ema_mu, device=device,
                                                dropout=dropout, tier=tier)
    local = make_train_sweep_step(model, optimizer, betas, sweep=sweep, base_step=base)
    shard = data_sharding(mesh, axis)

    def sweep_step(state, data: dict, idx: torch.Tensor, generator: torch.Generator):
        return local(state, data, _local_columns(idx, shard), generator)

    return sweep_step


def make_sharded_eval_step(diff_model, pose_model, betas, seq, mesh, *,
                           test_times: int = 1, eta: float = 0.0, use_ema: bool = False,
                           hyp_axis: Optional[str] = None, impl: str = "module", device="cuda",
                           tier: str = "bf16x3") -> Callable:
    """The multi-rank eval step: frames shard over ``data``; with ``hyp_axis``
    (a second mesh axis) each rank also solves ``test_times / hyp_size`` of
    the hypotheses and their mean is a sum over that axis's group.

    Returns ``step(state, pose, batch, generator=None, prepared=None) → (p1,
    p2, pred_xyz)`` over this rank's slice of the frames (``batch`` is that
    slice); ``step.prepare`` as on the single-process step."""
    from diffpose_tpu_torch.train.steps import make_eval_step

    return make_eval_step(diff_model, pose_model, betas, seq, test_times=test_times, eta=eta,
                          use_ema=use_ema, impl=impl, device=device, tier=tier,
                          hyp_axis=mesh_axis(mesh, hyp_axis) if hyp_axis else None)


# ----------------------------------------------------------------------
# the implicit (IGCN) family
# ----------------------------------------------------------------------

def make_sharded_implicit_train_step(model, optimizer, betas, mesh, *, axis: str = "data",
                                     impl: str = "module", ema_mu: Optional[float] = 0.999,
                                     use_warm_start: bool = False, tol_schedule=None,
                                     device="cuda", dropout: str = "masks",
                                     remat: bool = False, tier: str = "bf16x3") -> Callable:
    """Data-parallel IGCN training: gradients, loss and the BatchNorm running
    buffers the step writes are averaged over ``axis``; ``fp_iterations`` is
    averaged and ``fp_residual`` the maximum (each rank solves its own slice,
    with its own batch statistics, as a ``shard_map`` shard does).

    ``step(state, batch, generator[, z0, z0_weight])``: with
    ``use_warm_start`` ``z0`` is this rank's slice and
    ``metrics["fixed_point"]`` comes back as this rank's slice, never
    gathered."""
    from diffpose_tpu_torch.train.implicit_steps import make_implicit_train_step

    return make_implicit_train_step(model, optimizer, betas, impl=impl, ema_mu=ema_mu,
                                    use_warm_start=use_warm_start, tol_schedule=tol_schedule,
                                    device=device, dropout=dropout, remat=remat,
                                    axis=mesh_axis(mesh, axis), tier=tier)


def make_sharded_implicit_train_sweep_step(model, optimizer, betas, mesh, *, sweep: int,
                                           axis: str = "data", use_warm_start: bool = False,
                                           warm_start_momentum: float = 0.0,
                                           base_step: Optional[Callable] = None,
                                           **kwargs) -> Callable:
    """The implicit sweep over the mesh: ``sweep_step(state, data, idx,
    generator[, z0, z0_weight])`` with ``data`` replicated and ``idx`` the
    global ``[sweep, B]`` index array (each rank takes its columns); with
    warm start the fixed-point carry is this rank's slice from step to step.
    ``kwargs`` go to :func:`make_sharded_implicit_train_step`."""
    from diffpose_tpu_torch.train.implicit_steps import make_implicit_train_sweep_step

    base = base_step or make_sharded_implicit_train_step(
        model, optimizer, betas, mesh, axis=axis, use_warm_start=use_warm_start, **kwargs)
    local = make_implicit_train_sweep_step(model, optimizer, betas, sweep=sweep, base_step=base,
                                           use_warm_start=use_warm_start,
                                           warm_start_momentum=warm_start_momentum)
    shard = data_sharding(mesh, axis)

    def sweep_step(state, data: dict, idx: torch.Tensor, generator: torch.Generator, *carry):
        return local(state, data, _local_columns(idx, shard), generator, *carry)

    return sweep_step


def make_sharded_implicit_eval_step(implicit_model, pose_model, mesh, *, t_infer: int,
                                    test_times: int = 1, use_ema: bool = False,
                                    gmm_base_seed: int = 0,
                                    use_warm_start: bool = False, impl: str = "module",
                                    device="cuda", tier: str = "bf16x3") -> Callable:
    """Sharded direct-inference eval: frames shard over ``data`` and each rank
    runs its own fixed-point solve, so convergence and the Anderson history
    are per shard (the reference's chunked eval, where each chunk solves
    alone, ``implicit_pose.py:222-268``); the early-exit solve reads its
    test on this rank's host, with no collective inside the loop.  With a
    fixed iteration count and the damped solver the result equals the
    single-process one.

    Returns ``step(state, pose, batch, generator=None, z0=None,
    z0_weight=None, prepared=None) → (p1, p2, pred, iters[, fp])`` over this
    rank's slice, ``iters`` a 1-element tensor (this rank's count), ``z0`` /
    ``fp`` this rank's slice.  The step has no collective: ``mesh`` only
    names the layout its caller slices the batch by."""
    from diffpose_tpu_torch.train.implicit_steps import make_implicit_eval_step

    local = make_implicit_eval_step(implicit_model, pose_model, t_infer=t_infer,
                                    test_times=test_times, use_ema=use_ema,
                                    gmm_base_seed=gmm_base_seed, use_warm_start=use_warm_start,
                                    impl=impl, device=device, tier=tier)

    def step(state, pose, batch, generator=None, z0=None, z0_weight=None, prepared=None):
        out = list(local(state, pose, batch, generator, z0, z0_weight, prepared=prepared))
        out[3] = torch.as_tensor(out[3]).reshape(1)
        return tuple(out)

    step.prepare = local.prepare
    return step


# ----------------------------------------------------------------------
# the video family: windows over data, frames over context
# ----------------------------------------------------------------------

# The per-frame arrays of a video batch ([B, F, ...]); the rest is per window.
FRAME_KEYS = ("poses_3d", "poses_2d_gmm")


def shard_windows(mesh, batch: dict, data_axis: Optional[str] = "data",
                  cp_axis: Optional[str] = None, device=None) -> dict:
    """This rank's block of a ``[B, F, ...]`` video batch: its rows over
    ``data_axis`` and, of the per-frame arrays (:data:`FRAME_KEYS`), its
    contiguous frames over ``cp_axis``; per-window values (``seeds``,
    ``action_ids``...) shard over data only.  An axis given as None (or not
    on the mesh) leaves that dimension whole.  Each value on ``device`` when
    one is given."""
    rows = data_sharding(mesh, data_axis) if data_axis else Shard(0, 1)
    frames = data_sharding(mesh, cp_axis) if cp_axis else Shard(0, 1)
    out = {}
    for k, v in batch.items():
        part = v[rows.rows(v.shape[0])]
        if k in FRAME_KEYS:
            part = part[:, frames.rows(part.shape[1])]
        if device is not None:
            part = torch.as_tensor(np.ascontiguousarray(part) if isinstance(part, np.ndarray)
                                   else part.contiguous(), device=device)
        out[k] = part
    return out


def gather_windows(t: torch.Tensor, data: MeshAxis, context: MeshAxis) -> torch.Tensor:
    """Every rank's ``[B_local, F_local, ...]`` block (a per-frame error or
    prediction) joined into the global ``[B, F, ...]``: the frames over
    ``context``, then the windows over ``data`` (:func:`gather_rows` twice)."""
    t = gather_rows(t.transpose(0, 1).contiguous(), context).transpose(0, 1)
    return gather_rows(t.contiguous(), data)


def _bound(model, mesh, cp_axis: Optional[str]):
    """``model`` bound to ``mesh``'s ``cp_axis`` (checked against the name it
    was built with), or unbound without one."""
    if cp_axis is not None and model.cp_axis != cp_axis:
        raise ValueError(f"the model was built with cp_axis={model.cp_axis!r}, not {cp_axis!r}")
    return model.bind_mesh(mesh if cp_axis is not None else None)


def make_sharded_video_train_step(model, optimizer, betas, mesh, *,
                                  data_axis: Optional[str] = "data",
                                  cp_axis: Optional[str] = None, impl: str = "module",
                                  ema_mu: Optional[float] = 0.999, mask=None, device="cuda",
                                  dropout: str = "masks", tier: str = "bf16x3") -> Callable:
    """Video training over a 1-D or 2-D mesh: ``step(state, batch, generator)
    → (state, metrics)`` with ``batch`` this rank's block
    (:func:`shard_windows`).  Windows shard over ``data_axis`` (gradients
    averaged), frames over ``cp_axis`` (the model, built with that
    ``cp_axis`` and bound here, gathers the keys and values; the
    frame-summed loss and gradients add), one ``all_reduce`` over both.
    ``data_axis=None``: context parallelism alone.  Counterpart of
    ``diffpose_tpu/parallel/sharding.py:make_sharded_video_train_step``; its
    ``base_step`` (the fused Pallas step, data axis only) is ``impl="fused"``
    here, which refuses a ``cp_axis``.  ``step.draw`` / ``step.apply`` as on
    the single-process step."""
    from diffpose_tpu_torch.train.video_steps import make_video_train_step

    _bound(model, mesh, cp_axis)
    return make_video_train_step(
        model, optimizer, betas, impl=impl, ema_mu=ema_mu, mask=mask, device=device,
        dropout=dropout, data_axis=mesh_axis(mesh, data_axis) if data_axis else None,
        cp_axis=mesh_axis(mesh, cp_axis) if cp_axis else None, tier=tier)


def make_sharded_video_eval_step(model, betas, seq, mesh, *, frames_total: int,
                                 data_axis: Optional[str] = "data",
                                 cp_axis: Optional[str] = None, test_times: int = 1,
                                 eta: float = 0.0, mask=None, use_ema: bool = False,
                                 denoise_override=None, device="cuda",
                                 tier: str = "bf16x3") -> Callable:
    """Windowed DDIM eval over the mesh: ``step(state, batch, generator=None,
    prepared=None) → (p1, p2, pred)`` over this rank's block, ``[B_local,
    F_local]`` errors (:func:`gather_windows` joins them).  The per-(window,
    frame) GMM keys make the result layout-invariant at ``eta = 0``.
    ``denoise_override``: a fused forward (``ops/fused_video.py``), run on
    this rank's frames with the key/value gather inside it; the whole-window
    ones (``fused_st``, ``fused_full``) refuse a context axis of more than
    one rank.  Counterpart of ``make_sharded_video_eval_step``."""
    from diffpose_tpu_torch.train.video_steps import make_video_eval_step

    _bound(model, mesh, cp_axis)
    return make_video_eval_step(
        model, betas, seq, test_times=test_times, eta=eta, mask=mask, use_ema=use_ema,
        frames_total=frames_total, denoise_override=denoise_override, device=device, tier=tier,
        data_axis=mesh_axis(mesh, data_axis) if data_axis else None,
        cp_axis=mesh_axis(mesh, cp_axis) if cp_axis else None)
