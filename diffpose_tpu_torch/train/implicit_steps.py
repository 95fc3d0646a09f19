"""Train and eval steps of the implicit (IGCN) family.
Counterpart of ``diffpose_tpu/train/implicit_steps.py``.

Differences from the frame family's steps (reference ``runners/implicit_pose.py``):

* the model's forward is a fixed-point solve returning ``(ε̂, aux)`` and
  moving the BatchNorm running buffers, which live in the module;
* evaluation runs no DDIM loop: one solve at ``t = test_num_diffusion_timesteps``
  (``implicit_pose.py:523-526``).

A train step is ``draw`` then ``apply``, as in ``train/steps.py``; the
module's parameters, buffers, optimizer and EMA shadow are updated in place.
With ``axis`` (one rank of a mesh, ``parallel/sharding.py``) the draws are
keyed by the rank's coordinate, and the gradients, the loss and the
BatchNorm running buffers are averaged over the axis, ``fp_iterations``
averaged and ``fp_residual`` the maximum
(``diffpose_tpu/train/implicit_steps.py:95-102``).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from diffpose_tpu_torch.data.gmm import sample_gmm_batch_per_sample
from diffpose_tpu_torch.metrics import mpjpe_per_sample, p_mpjpe_per_sample
from diffpose_tpu_torch.models.ema import ema_update
from diffpose_tpu_torch.models.igcn import bn_state
from diffpose_tpu_torch.ops.fused_denoiser import fused_lifter, prepare_weights, resolve_device
from diffpose_tpu_torch.ops.fused_igcn import make_igcn_fn
from diffpose_tpu_torch.ops.fused_igcn_train import make_igcn_train_fn
from diffpose_tpu_torch.parallel.mesh import MeshAxis
from diffpose_tpu_torch.parallel.sharding import all_reduce_mean_grads, max_over
from diffpose_tpu_torch.train.state import TrainState
from diffpose_tpu_torch.train.steps import (
    DROPOUTS,
    StepDraws,
    _swapped_in,
    diffusion_loss,
    make_draw,
)

IMPLS = ("module", "fused")
BN_BUFFERS = ("running_mean", "running_var")


def progressive_tolerance(step: int, tol_schedule: Tuple[float, float, int]) -> float:
    """The solver tolerance at global ``step``: linear from ``init_tol`` to
    ``final_tol`` over ``decay_steps``, then flat; in float32, as the JAX step
    computes it (``implicit_steps.py:64-70``)."""
    init_tol, final_tol, decay_steps = tol_schedule
    f32 = np.float32
    frac = np.clip(f32(step) / f32(max(decay_steps, 1)), f32(0), f32(1))
    return float(f32(init_tol) + (f32(final_tol) - f32(init_tol)) * frac)


def _check_mask(mask):
    if mask is not None and not bool((torch.as_tensor(mask) != 0).all()):
        raise ValueError("the implicit family's steps take the all-ones joint mask only")


def make_implicit_train_step(model, optimizer, betas, *, impl: str = "module",
                             ema_mu: Optional[float] = 0.999, mask=None,
                             use_warm_start: bool = False,
                             tol_schedule: Optional[Tuple[float, float, int]] = None,
                             device="cuda", dropout: str = "masks", remat: bool = False,
                             axis: Optional[MeshAxis] = None):
    """Build ``train_step(state, batch, generator, z0=None, z0_weight=None)
    → (state, metrics)`` for an :class:`~diffpose_tpu_torch.models.IGCN`.

    ``impl="module"``: ``IGCN.forward`` in training mode (the plain stack,
    ``ops/train_ref.layers_forward``) under autograd; ``"fused"``: the stack
    of every solver iteration through the CUDA kernel pair
    (``ops/fused_igcn_train.py``; on a CPU device their plain versions).
    Both take one dropout draw a step (``dropout``: ``"masks"`` or
    ``"prng"``, see ``train/steps.py:make_draw``), so with the same draws
    they compute the same step.

    ``use_warm_start``: ``(z0, z0_weight)`` warm-start the solve and
    ``metrics["fixed_point"]`` carries the solution (detached) for the next
    step.  ``tol_schedule=(init_tol, final_tol, decay_steps)``: the
    progressive tolerance, from ``state.step``.  ``remat`` (fused only):
    recompute each iteration's stack in the backward.  ``axis``: one rank of
    a mesh (the module's docstring).

    ``metrics``: ``loss``, ``grad_norm``, ``fp_iterations``, ``fp_residual``
    (tensors on the device), plus ``fp_tolerance`` and ``fixed_point`` where
    those apply.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if dropout not in DROPOUTS:
        raise ValueError(f"dropout must be one of {DROPOUTS}, got {dropout!r}")
    _check_mask(mask)
    device = resolve_device(device)
    if next(model.parameters()).device.type != device.type:
        raise ValueError(f"the model lies on {next(model.parameters()).device}, not on {device}")
    fused = impl == "fused"
    draw = make_draw(betas, device, num_layers=model.num_layers, num_heads=model.num_heads,
                     hid_dim=model.hid_dim, dropout=dropout,
                     masks_dtype=torch.uint8 if fused else torch.float32, axis=axis)
    forward = make_igcn_train_fn(model, dropout=dropout, remat=remat) if fused else None

    def apply(state: TrainState, draws: StepDraws, z0=None, z0_weight=None):
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("the state holds another model or optimizer than the step")
        model.train()
        optimizer.zero_grad()
        tol = progressive_tolerance(state.step, tol_schedule) if tol_schedule else None
        t = draws.t.to(torch.float32)
        if fused:
            drop = draws.seed if dropout == "prng" else draws.masks
            eps, aux, running = forward(draws.x_t, t, drop, z0, z0_weight, tol)
        else:   # the module moves its running buffers itself
            eps, aux = model(draws.x_t, t, masks=draws.masks, z0=z0, z0_weight=z0_weight,
                             tolerance_override=tol)
            running = {k: getattr(model.batch_norm, k) for k in BN_BUFFERS}
        loss = diffusion_loss(eps, draws.e)
        loss.backward()
        iterations = aux["iterations"].to(torch.float32)
        residual = aux["residual"].detach()
        if axis is not None:
            # one all_reduce: the gradients, the loss, the mean iteration count
            # and the running buffers this step wrote (each rank's solve
            # converges on its own slice); the residual's maximum
            loss, iterations, *bn = all_reduce_mean_grads(
                model.parameters(), axis, loss, iterations, *running.values())
            running = dict(zip(BN_BUFFERS, bn))
            residual = max_over(residual, axis)
        if fused or axis is not None:
            with torch.no_grad():
                for k, v in running.items():
                    getattr(model.batch_norm, k).copy_(v)
        grad_norm = optimizer.step()
        if state.ema_params is not None and ema_mu is not None:
            ema_update(state.ema_params, model, ema_mu)
        state.step += 1
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm,
                   "fp_iterations": iterations, "fp_residual": residual}
        if tol is not None:
            metrics["fp_tolerance"] = torch.tensor(tol, dtype=torch.float32)
        if use_warm_start:
            metrics["fixed_point"] = aux["fixed_point"].detach()
        return state, metrics

    def train_step(state: TrainState, batch: dict, generator: torch.Generator, z0=None,
                   z0_weight=None):
        return apply(state, draw(batch, generator), z0, z0_weight)

    train_step.draw, train_step.apply = draw, apply
    return train_step


def make_implicit_train_sweep_step(model, optimizer, betas, *, sweep: int,
                                   use_warm_start: bool = False,
                                   warm_start_momentum: float = 0.0, base_step=None, **kwargs):
    """Device-resident-data training: ``sweep`` implicit steps per call, over
    a dataset that lies on the device (the implicit twin of
    ``train/steps.py:make_train_sweep_step``).  The BatchNorm buffers move
    in the module; with ``use_warm_start`` the fixed point is carried from
    step to step, at the caller's ``z0_weight`` for the first step and
    ``warm_start_momentum`` from the second on (``igcn.py:309-313``).

    Returns ``sweep_step(state, data, idx, generator[, z0, z0_weight]) →
    (state, metrics)`` with ``[sweep]`` metric vectors; with warm start
    ``metrics["fixed_point"]`` is the last step's solution.  ``base_step``
    replaces ``make_implicit_train_step(model, optimizer, betas, **kwargs)``.
    """
    base = base_step or make_implicit_train_step(model, optimizer, betas,
                                                 use_warm_start=use_warm_start, **kwargs)

    def sweep_step(state: TrainState, data: dict, idx: torch.Tensor,
                   generator: torch.Generator, z0=None, z0_weight=None):
        if idx.shape[0] != sweep:
            raise ValueError(f"idx holds {idx.shape[0]} steps, the sweep was built for {sweep}")
        per_step = []
        for ids in idx:
            batch = {k: data[k].index_select(0, ids) for k in ("poses_3d", "poses_2d_gmm")}
            if use_warm_start:
                state, metrics = base(state, batch, generator, z0, z0_weight)
                z0, z0_weight = metrics.pop("fixed_point"), warm_start_momentum
            else:
                state, metrics = base(state, batch, generator)
            per_step.append(metrics)
        out = {k: torch.stack([torch.as_tensor(m[k]) for m in per_step]) for k in per_step[0]}
        if use_warm_start:
            out["fixed_point"] = z0
        return state, out

    return sweep_step


@torch.no_grad()
def _weights_of(state, pose, use_ema: bool, device):
    """The lifter's and the IGCN's stacked weights and the IGCN's BatchNorm
    state, the EMA shadow in place of the live parameters with ``use_ema``
    (the running buffers stay live: EMA covers parameters only)."""
    ema = state.ema_params if use_ema and state.ema_params is not None else None
    with _swapped_in(state.model, ema):
        diff_w = prepare_weights(state.model, device=device)
        bn = {k: v.clone() for k, v in bn_state(state.model).items()}
    return prepare_weights(pose, device=device), diff_w, bn


def make_implicit_eval_step(implicit_model, pose_model, *, t_infer: int, test_times: int = 1,
                            mask=None, use_ema: bool = False, gmm_base_seed: int = 0,
                            use_warm_start: bool = False, impl: str = "module", device="cuda"):
    """Direct-inference eval: lift → ONE fixed-point solve at ``t_infer`` →
    hypothesis mean → P1/P2 (``diffpose_tpu/train/implicit_steps.py:211-283``).

    ``impl="fused"``: the lift is ``fused_lifter`` (kernel row 2) and the
    solve ``ops/fused_igcn.py:make_igcn_fn`` (row 3 once per iteration); on
    a CPU device their plain versions.  ``impl="module"``: the modules'
    forwards.

    Returns ``eval_step(state, pose, batch, generator=None, z0=None,
    z0_weight=None, prepared=None) → (p1 [B], p2 [B], pred_xyz [B, J, 3],
    iterations[, fixed_point])``; the fixed point is returned with
    ``use_warm_start``, for the next batch's ``z0``.  ``eval_step.prepare
    (state, pose)`` stacks the weights under evaluation once
    (``impl="fused"``); pass it as ``prepared`` to every batch of one
    evaluation.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    _check_mask(mask)
    device = resolve_device(device)
    solve = make_igcn_fn(implicit_model, device=device) if impl == "fused" else None

    def prepare(state, pose):
        return _weights_of(state, pose, use_ema, device) if impl == "fused" else None

    @torch.no_grad()
    def eval_step(state: TrainState, pose, batch: dict, generator=None, z0=None, z0_weight=None,
                  prepared=None):
        if state.model is not implicit_model:
            raise ValueError("the state holds another model than the step")
        pose = pose_model if pose is None else pose
        gmm = torch.as_tensor(batch["poses_2d_gmm"], device=device)
        poses_3d = torch.as_tensor(batch["poses_3d"], device=device)
        seeds = torch.as_tensor(batch["seeds"], device=device)
        _, _, input_2d = sample_gmm_batch_per_sample(gmm_base_seed, seeds, gmm, poses_3d)
        input_2d = input_2d.contiguous()   # a slice of the chosen kernels; the wrappers take no strides

        if impl == "fused":
            pose_w, diff_w, bn = prepared if prepared is not None else prepare(state, pose)
            lift = functools.partial(fused_lifter, pose_w)
            denoise = functools.partial(solve, diff_w, bn)
            swap = contextlib.nullcontext()
        else:
            implicit_model.eval()
            pose.eval()
            lift = pose
            denoise = functools.partial(implicit_model, differentiable=False)
            ema = state.ema_params if use_ema and state.ema_params is not None else None
            swap = _swapped_in(implicit_model, ema)

        xyz = lift(input_2d)
        xyz = xyz - xyz[:, :1, :]
        uvxyz = torch.cat([input_2d, xyz], dim=-1).repeat(test_times, 1, 1)
        t_vec = torch.full((uvxyz.shape[0],), float(t_infer), dtype=uvxyz.dtype, device=device)
        with swap:
            out, aux = denoise(uvxyz, t_vec, z0=z0, z0_weight=z0_weight)
        out = out.reshape(test_times, -1, out.shape[1], out.shape[2]).mean(dim=0)

        pred_xyz = out[..., 2:]
        pred_xyz = pred_xyz - pred_xyz[:, :1, :]
        target = poses_3d - poses_3d[:, :1, :]
        p1, p2 = mpjpe_per_sample(pred_xyz, target), p_mpjpe_per_sample(pred_xyz, target)
        if use_warm_start:
            return p1, p2, pred_xyz, aux["iterations"], aux["fixed_point"]
        return p1, p2, pred_xyz, aux["iterations"]

    eval_step.prepare = prepare
    return eval_step
