"""Train and eval steps of the video (spatio-temporal) family.

Counterpart of ``diffpose_tpu/train/video_steps.py``: the frame family's
GMM-diffusion objective applied per frame of ``[B, F, J, …]`` windows, with
one diffusion timestep per *window* (the whole window is noised
coherently), the ε-MSE summed over frames, joints and coordinates and
averaged over windows.

Over a mesh (``parallel/sharding.py:make_sharded_video_train_step``,
``make_sharded_video_eval_step``) the steps take ``data_axis`` and ``cp_axis``
as ``parallel.mesh.MeshAxis`` values: windows shard over ``data``, each
window's frames over ``context`` (the model bound to the mesh gathers the
keys and values).  The train step draws from its generator folded with the
data coordinate (``parallel/sharding.py:fold_in``); the window's timestep
comes from that stream alone, so every frame shard of a window has the same
``t``, and the per-frame draws (GMM kernel, noise, dropout) from it folded
again with the context coordinate.  Gradients and loss are summed over
context (the loss sums over frames) and averaged over data, in one
``all_reduce`` over the mesh.

As in ``train/steps.py`` the train step splits in ``draw(batch, generator)``
and ``apply(state, draws)``; the state's model, optimizer and EMA shadow are
updated in place.
"""

from __future__ import annotations

import contextlib
import functools
from typing import NamedTuple, Optional, Sequence

import torch

from diffpose_tpu_torch.data.gmm import sample_gmm_batch, sample_gmm_batch_per_sample
from diffpose_tpu_torch.diffusion.ddim import (
    antithetic_timesteps,
    ddim_sample,
    q_sample,
    q_sample_tables,
)
from diffpose_tpu_torch.metrics import mpjpe_per_sample, p_mpjpe_per_sample
from diffpose_tpu_torch.models.ema import ema_update
from diffpose_tpu_torch.ops.fused_denoiser import resolve_device
from diffpose_tpu_torch.ops.fused_video_full import prepare_video_weights, video_tier_weights
from diffpose_tpu_torch.ops.fused_video_train import (
    TemporalMasks,
    make_temporal_masks,
    make_video_train_fn,
    plain_stack,
    video_dropout_rates,
    wrap_int32,
)
from diffpose_tpu_torch.ops.train_ref import DropoutMasks, make_dropout_masks
from diffpose_tpu_torch.parallel.mesh import MeshAxis
from diffpose_tpu_torch.parallel.sharding import all_reduce_mean_grads, fold_in, joint_axis
from diffpose_tpu_torch.train.state import TrainState
from diffpose_tpu_torch.train.steps import DROPOUTS, IMPLS, _INT32_MAX, _INT32_MIN, _swapped_in
from diffpose_tpu_torch.utils.profiling import span


class VideoDraws(NamedTuple):
    """Everything random in one video step."""

    x_t: torch.Tensor                    # [B, F, J, 5] noised windows
    t: torch.Tensor                      # [B] int64 timesteps, one a window
    e: torch.Tensor                      # [B, F, J, 5] target noise, scaled per coordinate
    masks: Optional[DropoutMasks]        # spatial masks at B·F rows (None: module, or prng)
    seed: Optional[torch.Tensor]         # int32[1], dropout="prng"
    tmasks: Optional[TemporalMasks]      # temporal masks at B·J rows (None: module, or rate 0)
    drop_seed: Optional[int] = None      # impl="module" over a mesh: its nn.Dropout's seed


@contextlib.contextmanager
def _default_generator_seeded(device: torch.device, seed: Optional[int]):
    """Run the body with ``device``'s default generator (the one ``nn.Dropout``
    draws from) seeded with ``seed``, then put its state back; ``None``
    leaves it alone."""
    if seed is None:
        yield
        return
    g = (torch.cuda.default_generators[device.index if device.index is not None
                                       else torch.cuda.current_device()]
         if device.type == "cuda" else torch.default_generator)
    saved = g.get_state()
    g.manual_seed(seed)
    try:
        yield
    finally:
        g.set_state(saved)


def make_video_train_step(model, optimizer, betas, *, impl: str = "fused",
                          ema_mu: Optional[float] = 0.999, mask=None,
                          data_axis: Optional[MeshAxis] = None,
                          cp_axis: Optional[MeshAxis] = None, device="cuda",
                          dropout: str = "masks", tier: str = "bf16x3"):
    """Build ``train_step(state, batch, generator) → (state, metrics)``.

    ``impl="module"``: ``SpatioTemporalDiff.train()`` under autograd, its
    ``nn.Dropout`` drawing from torch's default generator; ``"fused"``: the
    spatial blocks through the train kernel pair
    (``ops/fused_video_train.py``; on a CPU device their plain versions);
    ``"plain"``: the same forward with the pair's plain twin.  ``dropout``
    (fused and plain): ``"masks"`` draws the spatial masks from the
    generator, ``"prng"`` one seed (the kernels draw the masks, layer ``i``
    from ``seed + i·1000003``).  The temporal masks come from the generator.
    ``batch``: ``poses_3d [B, F, J, 3]``, ``poses_2d_gmm [B, F, J, K, 5]``.
    ``metrics``: ``loss`` and ``grad_norm``, scalar tensors on ``device``.
    ``tier``: the kernel pair's ``--kernel_precision`` (``"plain"`` at a
    reduced tier: the pair's plain tier versions behind the same autograd
    function, ``make_video_train_fn(..., plain=True)``).

    ``data_axis`` / ``cp_axis``: the step runs on one rank of a mesh, on its
    windows and, over ``cp_axis``, its frames of each (the model bound to the
    mesh, ``SpatioTemporalDiff.bind_mesh``); the draws and the reduction are
    the module's docstring's.  Over a mesh ``impl="module"`` seeds the
    default generator for its ``nn.Dropout`` from the folded stream
    (``VideoDraws.drop_seed``), so that no two ranks repeat one mask.  The
    fused and plain forwards own whole windows (the JAX package's
    ``pallas_video_train.py`` likewise runs under the data axis only): with
    a ``cp_axis`` they raise.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if dropout not in DROPOUTS:
        raise ValueError(f"dropout must be one of {DROPOUTS}, got {dropout!r}")
    if dropout == "prng" and impl == "module":
        raise ValueError("impl='module' draws its dropout with nn.Dropout; dropout='prng' "
                         "belongs to impl='fused' and 'plain'")
    if cp_axis is not None and impl != "module":
        raise ValueError(f"impl={impl!r} runs the spatial blocks on whole windows; under a "
                         "context axis only impl='module' trains (the K/V gather lives in the "
                         "module's temporal attention)")
    device = resolve_device(device)
    if next(model.parameters()).device.type != device.type:
        raise ValueError(f"the model lies on {next(model.parameters()).device}, not on {device}")
    meshed = data_axis is not None or cp_axis is not None
    frame_fold = cp_axis is not None and cp_axis.size > 1
    mesh_all = joint_axis(data_axis, cp_axis)
    data_size = data_axis.size if data_axis is not None else 1
    prng = dropout == "prng"
    rates = video_dropout_rates(model)
    t_rate = float(model.dropout_rate)
    num_timesteps = len(betas)
    tables = q_sample_tables(betas, torch.float32, device)
    train_fn = None
    if impl != "module":
        parity_plain = impl == "plain" and tier == "bf16x3"
        train_fn = make_video_train_fn(model, dropout=dropout, rates=rates,
                                       stack_fn=plain_stack(rates) if parity_plain else None,
                                       tier=tier, plain=impl == "plain")
    masks_dtype = torch.uint8 if impl == "fused" else torch.float32

    def draw(batch: dict, generator: torch.Generator) -> VideoDraws:
        # the window's stream (t) and the frames' (the rest): one stream
        # unsharded and at context size 1, in the unsharded step's order
        if data_axis is not None:
            generator = fold_in(generator, data_axis.index)
        frames_gen = fold_in(generator, cp_axis.index) if frame_fold else generator
        p3 = torch.as_tensor(batch["poses_3d"], device=device)
        gmm = torch.as_tensor(batch["poses_2d_gmm"], device=device)
        b, f, j = p3.shape[:3]
        uvxyz, noise_scale, _ = sample_gmm_batch(
            frames_gen, gmm.reshape(b * f, j, gmm.shape[3], 5), p3.reshape(b * f, j, 3))
        uvxyz, noise_scale = uvxyz.reshape(b, f, j, 5), noise_scale.reshape(b, f, j, 5)
        t = antithetic_timesteps(generator, b, num_timesteps)
        e = torch.randn(uvxyz.shape, generator=frames_gen, device=device,
                        dtype=uvxyz.dtype) * noise_scale
        x_t = q_sample(uvxyz, t, e, betas, tables)
        masks = seed = tmasks = drop_seed = None
        if impl != "module":
            if prng:
                seed = torch.randint(_INT32_MIN, _INT32_MAX, (1,), generator=frames_gen,
                                     device=device, dtype=torch.int32)
            else:
                masks = make_dropout_masks(frames_gen, num_layers=model.num_layers, n_pts=j,
                                           batch=b * f, num_heads=model.num_heads,
                                           hid_dim=model.hid_dim, rates=rates, dtype=masks_dtype)
            if t_rate > 0:
                tmasks = make_temporal_masks(frames_gen, num_layers=model.num_layers,
                                             rows=b * j, frames=f, num_heads=model.num_heads,
                                             hid_dim=model.hid_dim, rate=t_rate)
        elif meshed:
            drop_seed = fold_in(frames_gen, 0).initial_seed()     # read on the host, no sync
        return VideoDraws(x_t, t, e, masks, seed, tmasks, drop_seed)

    def apply(state: TrainState, draws: VideoDraws):
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("the state holds another model or optimizer than the step")
        model.train()
        optimizer.zero_grad()
        t = draws.t.to(torch.float32)
        if impl == "module":
            with _default_generator_seeded(device, draws.drop_seed):
                eps = model(draws.x_t, t, mask)
        else:
            eps = train_fn(draws.x_t, t, draws.seed if prng else draws.masks, draws.tmasks)
        loss = ((draws.e - eps) ** 2).sum(dim=(1, 2, 3)).mean()
        loss.backward()
        if mesh_all.group is not None:
            # summed over context, averaged over data: one flat all_reduce
            loss, = all_reduce_mean_grads(model.parameters(), mesh_all, loss, divisor=data_size)
        grad_norm = optimizer.step()
        if state.ema_params is not None and ema_mu is not None:
            ema_update(state.ema_params, model, ema_mu)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}

    def train_step(state: TrainState, batch: dict, generator: torch.Generator):
        return apply(state, draw(batch, generator))

    train_step.draw, train_step.apply = draw, apply
    return train_step


def make_video_eval_step(model, betas, seq: Sequence[int], *, test_times: int = 1,
                         eta: float = 0.0, mask=None, use_ema: bool = False,
                         gmm_base_seed: int = 0, cp_axis: Optional[MeshAxis] = None,
                         data_axis: Optional[MeshAxis] = None,
                         frames_total: Optional[int] = None, denoise_override=None,
                         device="cuda", tier: str = "bf16x3"):
    """Window eval: per-frame GMM draw of the 2D input and a zero xyz guess →
    DDIM over the window → hypothesis mean → root-centred per-frame P1/P2
    ``[B, F]``.  Counterpart of ``diffpose_tpu/train/video_steps.py:37``.

    The GMM draw of frame ``f`` of a window with id ``s`` is keyed by
    ``s·F_total + f`` (int32), ``f`` the frame's place in the whole window,
    so it depends on neither the batch nor the layout.  Over a mesh
    (``data_axis``, ``cp_axis`` as ``parallel.mesh.MeshAxis``; the model
    bound to it) the batch is this rank's windows and, over ``cp_axis``,
    its ``F_local = frames_total / size`` frames of each, whose first is
    ``index·F_local``; the errors come back ``[B_local, F_local]``.  With
    ``eta = 0`` (the reference protocol) the result does not depend on the
    layout; with ``eta != 0`` the DDIM generator is folded with both
    coordinates, so no two shards draw the same noise.
    ``denoise_override(vw, x, t) → ε̂`` replaces the module forward with a
    fused one (``ops/fused_video.py``, ``ops/fused_video_full.py``) over
    ``vw = eval_step.prepare(state)``, the weights' snapshot (the EMA
    shadow with ``use_ema``) at the kernels' tier ``tier``
    (``video_tier_weights``).  Returns ``eval_step(state, batch, generator
    =None, prepared=None) → (p1 [B, F], p2 [B, F], pred_xyz [B, F, J, 3])``.
    """
    device = resolve_device(device)
    seq = tuple(int(s) for s in seq)
    axes = [a for a in (data_axis, cp_axis) if a is not None]

    def ema_of(state):
        return state.ema_params if use_ema and state.ema_params is not None else None

    @torch.no_grad()
    def prepare(state):
        if denoise_override is None:
            return None
        with _swapped_in(state.model, ema_of(state)):
            return video_tier_weights(prepare_video_weights(state.model, device=device), tier)

    @torch.no_grad()
    def eval_step(state, batch: dict, generator: Optional[torch.Generator] = None,
                  prepared=None):
        with span("step.eval"):
            return step_body(state, batch, generator, prepared)

    def step_body(state, batch, generator, prepared):
        if state.model is not model:
            raise ValueError("the state holds another model than the step")
        with span("step.inputs"):
            p3 = torch.as_tensor(batch["poses_3d"], device=device)
            gmm = torch.as_tensor(batch["poses_2d_gmm"], device=device)
            seeds = torch.as_tensor(batch["seeds"], device=device)
        b, f, j = p3.shape[:3]
        f_total = frames_total if frames_total is not None else f
        frame0 = cp_axis.index * f if cp_axis is not None else 0
        if f * (cp_axis.size if cp_axis is not None else 1) != f_total:
            raise ValueError(f"{f} frames a rank do not make {f_total}-frame windows")
        frame_ids = frame0 + torch.arange(f, device=device, dtype=torch.int64)
        ids = wrap_int32(seeds.to(torch.int64).repeat_interleave(f) * f_total
                         + frame_ids.repeat(b))
        with span("step.gmm"):
            _, _, input_2d = sample_gmm_batch_per_sample(
                gmm_base_seed, ids, gmm.reshape(b * f, j, gmm.shape[3], 5),
                p3.reshape(b * f, j, 3))
        input_2d = input_2d.reshape(b, f, j, 2)
        uvxyz = torch.cat([input_2d, torch.zeros((b, f, j, 3), dtype=p3.dtype, device=device)],
                          dim=-1).repeat(test_times, 1, 1, 1)

        if denoise_override is not None:
            vw = prepared if prepared is not None else prepare(state)
            denoise = functools.partial(denoise_override, vw)
            swap = contextlib.nullcontext()
        else:
            model.eval()
            denoise = functools.partial(model, mask=mask)
            swap = _swapped_in(model, ema_of(state))
        if eta != 0.0 and generator is not None:
            for a in axes:
                generator = fold_in(generator, a.index)
        with swap:
            out = ddim_sample(denoise, uvxyz, seq, betas, eta=eta, generator=generator)
        out = out.reshape(test_times, b, f, j, 5).mean(dim=0)

        pred = out[..., 2:]
        pred = pred - pred[..., :1, :]
        tgt = p3 - p3[..., :1, :]
        with span("metrics.errors"):
            p1 = mpjpe_per_sample(pred.reshape(b * f, j, 3), tgt.reshape(b * f, j, 3))
            p2 = p_mpjpe_per_sample(pred.reshape(b * f, j, 3), tgt.reshape(b * f, j, 3))
        return p1.reshape(b, f), p2.reshape(b, f), pred

    eval_step.prepare = prepare
    return eval_step
