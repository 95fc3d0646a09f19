"""Train and eval step functions of the frame family.

One step: GMM kernel draw → antithetic timesteps → ``e = randn·noise_scale``
→ q-sample → denoiser forward → ε-MSE → backward → global-norm clip →
optimizer → EMA (reference ``runners/diffpose_frame.py:203-236``).
Counterpart of ``diffpose_tpu/train/steps.py``.

Loss: ``‖e − ε̂‖²`` summed over joints and coordinates, mean over the batch
(``runners/diffpose_frame.py:226``).

The step is split in two so that a caller can supply the random draws:
``train_step.draw(batch, generator)`` and ``train_step.apply(state, draws)``;
``train_step(state, batch, generator)`` is one after the other.  The state's
model, optimizer and EMA shadow are updated in place.

``axis`` (a ``parallel.mesh.MeshAxis``) is set when the step runs on one rank
of a mesh (``parallel/sharding.py``): its draws are then keyed by the rank's
coordinate on the axis, and its gradients and loss averaged over the axis's
group, as ``axis_name`` does inside ``shard_map`` in the JAX package.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, NamedTuple, Optional, Sequence

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
from diffpose_tpu_torch.ops.fused_denoiser import (
    fused_denoiser,
    fused_lifter,
    prepare_weights,
    resolve_device,
    tier_weights,
)
from diffpose_tpu_torch.ops.fused_train import build_train_stack, fused_train_forward
from diffpose_tpu_torch.ops.philox import philox_masks
from diffpose_tpu_torch.ops.tf32 import PARITY_TIER
from diffpose_tpu_torch.ops.train_ref import DropoutMasks, make_dropout_masks, train_forward
from diffpose_tpu_torch.parallel.mesh import MeshAxis
from diffpose_tpu_torch.parallel.sharding import all_reduce_mean_grads, fold_in, sum_over
from diffpose_tpu_torch.train.state import TrainState
from diffpose_tpu_torch.utils.profiling import span

IMPLS = ("fused", "plain", "module")
DROPOUTS = ("masks", "prng")
_INT32_MIN, _INT32_MAX = -(1 << 31), (1 << 31) - 1


class StepDraws(NamedTuple):
    """Everything random in one step."""

    x_t: torch.Tensor                  # [B, J, 5] noised sample
    t: torch.Tensor                    # [B] int64 timesteps
    e: torch.Tensor                    # [B, J, 5] target noise, scaled per coordinate
    masks: Optional[DropoutMasks]      # None for impl="module" (nn.Dropout draws its own)
    seed: Optional[torch.Tensor] = None  # int32[1], dropout="prng": the masks' seed


def diffusion_loss(eps: torch.Tensor, target_noise: torch.Tensor) -> torch.Tensor:
    return ((target_noise - eps) ** 2).sum(dim=(1, 2)).mean()


def make_draw(betas, device: torch.device, *, num_layers: int, num_heads: int, hid_dim: int,
              dropout: str, masks_dtype, axis: Optional[MeshAxis] = None):
    """Build ``draw(batch, generator) → StepDraws``: GMM kernel, antithetic
    timesteps, scaled noise, q-sample, then the dropout's draw, all from
    ``generator`` folded with ``axis``'s coordinate where an axis is given
    (``parallel/sharding.py:fold_in``; that includes the Philox seed).  ``dropout
    ="masks"``: ``DropoutMasks`` of ``masks_dtype`` (``None``: no masks, the
    module's ``nn.Dropout`` draws its own); ``"prng"``: an int32 seed, and
    where the consumer takes explicit float masks (``masks_dtype`` float32)
    also the Philox masks of that seed (``ops/philox.py``, the kernels' bits)."""
    num_timesteps = len(betas)
    tables = q_sample_tables(betas, torch.float32, device)
    cfg = dict(num_layers=num_layers, num_heads=num_heads, hid_dim=hid_dim)

    def draw(batch: dict, generator: torch.Generator) -> StepDraws:
        if axis is not None:
            generator = fold_in(generator, axis.index)
        gmm = torch.as_tensor(batch["poses_2d_gmm"], device=device)
        uvxyz, noise_scale, _ = sample_gmm_batch(
            generator, gmm, torch.as_tensor(batch["poses_3d"], device=device))
        n, n_pts = uvxyz.shape[:2]
        t = antithetic_timesteps(generator, n, num_timesteps)
        e = torch.randn(uvxyz.shape, generator=generator, device=device,
                        dtype=uvxyz.dtype) * noise_scale
        x_t = q_sample(uvxyz, t, e, betas, tables)
        masks = seed = None
        if dropout == "prng":
            seed = torch.randint(_INT32_MIN, _INT32_MAX, (1,), generator=generator, device=device,
                                 dtype=torch.int32)
            if masks_dtype == torch.float32:
                masks = philox_masks(seed, n_pts=n_pts, batch=n, **cfg, device=device,
                                     dtype=torch.float32)
        elif masks_dtype is not None:
            masks = make_dropout_masks(generator, n_pts=n_pts, batch=n, **cfg, dtype=masks_dtype)
        return StepDraws(x_t, t, e, masks, seed)

    return draw


def make_train_step(model, optimizer, betas, *, impl: str = "fused",
                    ema_mu: Optional[float] = 0.999, device="cuda", dropout: str = "masks",
                    axis: Optional[MeshAxis] = None, tier: str = PARITY_TIER):
    """Build ``train_step(state, batch, generator) → (state, metrics)``.

    ``impl``: ``"fused"`` runs the denoiser's layers through the CUDA
    kernel pair of ``ops/fused_train.py`` (on a CPU device: their plain
    versions); ``"plain"`` is ``train_ref.train_forward`` under autograd
    with the same explicit masks; ``"module"`` is ``GCNDiff.train()`` under
    autograd with ``nn.Dropout``, which draws from torch's default
    generator.  ``dropout`` (``"fused"`` and ``"plain"``): ``"masks"`` draws
    explicit masks from the generator each step; ``"prng"`` draws one int32
    seed, from which the seeded kernel pair draws the masks itself (Philox,
    ``csrc/philox.cuh``; on a CPU device and for ``"plain"``:
    ``ops/philox.py:philox_masks``, the same bits).  ``model`` lies on ``device``; ``generator`` is a
    ``torch.Generator`` of that device; ``optimizer`` is
    ``train.optim.make_optimizer``'s.  ``batch``: ``poses_3d [B, J, 3]`` and
    ``poses_2d_gmm [B, J, K, 5]``.  ``metrics``: ``loss`` and ``grad_norm``
    (the global norm before the clip), scalar tensors on ``device``.
    ``axis``: the step runs on one rank of a mesh; gradients and loss are
    averaged over the axis before the clip (the module's docstring).
    ``tier``: the train kernels' ``--kernel_precision``: ``"fused"`` launches
    that tier's kernel pair; ``"plain"`` at a reduced tier runs the pair's
    plain tier versions behind the same autograd function
    (``build_train_stack(..., plain=True)``), not autograd of a rounded
    forward, which would be another function.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if dropout not in DROPOUTS:
        raise ValueError(f"dropout must be one of {DROPOUTS}, got {dropout!r}")
    if dropout == "prng" and impl == "module":
        raise ValueError("impl='module' draws its dropout with nn.Dropout; dropout='prng' "
                         "belongs to impl='fused' and 'plain'")
    prng = dropout == "prng"
    device = resolve_device(device)
    if next(model.parameters()).device.type != device.type:
        raise ValueError(f"the model lies on {next(model.parameters()).device}, not on {device}")
    cfg = dict(num_layers=model.num_layers, num_heads=model.num_heads, hid_dim=model.hid_dim)
    basis = model.gconv_input.basis.detach().cpu().numpy()
    stack_fn = None
    if impl == "fused":
        stack_fn = build_train_stack(basis, **cfg, dropout=dropout, tier=tier)
    elif impl == "plain" and tier != PARITY_TIER:
        stack_fn = build_train_stack(basis, **cfg, tier=tier, plain=True)
    draw = make_draw(betas, device, **cfg, dropout=dropout,
                     masks_dtype={"fused": torch.uint8, "plain": torch.float32}.get(impl),
                     axis=axis)

    def apply(state: TrainState, draws: StepDraws):
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("the state holds another model or optimizer than the step")
        model.train()
        optimizer.zero_grad()
        t = draws.t.to(torch.float32)
        if impl == "fused":
            eps = fused_train_forward(model, draws.x_t, t, draws.seed if prng else draws.masks,
                                      stack_fn)
        elif stack_fn is not None:
            eps = fused_train_forward(model, draws.x_t, t, draws.masks, stack_fn)
        elif impl == "plain":
            eps = train_forward(model, draws.x_t, t, draws.masks)
        else:
            eps = model(draws.x_t, t)
        loss = diffusion_loss(eps, draws.e)
        loss.backward()
        if axis is not None:
            loss, = all_reduce_mean_grads(model.parameters(), axis, loss)
        grad_norm = optimizer.step()
        if state.ema_params is not None and ema_mu is not None:
            ema_update(state.ema_params, model, ema_mu)
        state.step += 1
        return state, {"loss": loss.detach(), "grad_norm": grad_norm}

    def train_step(state: TrainState, batch: dict, generator: torch.Generator):
        return apply(state, draw(batch, generator))

    train_step.draw, train_step.apply = draw, apply
    return train_step


def make_train_sweep_step(model, optimizer, betas, *, sweep: int, impl: str = "fused",
                          ema_mu: Optional[float] = 0.999, device="cuda", dropout: str = "masks",
                          base_step: Optional[Callable] = None, tier: str = PARITY_TIER):
    """Device-resident-data training: ``sweep`` optimizer steps per call.

    The whole dataset lies on the device; the host sends one ``[sweep, B]``
    index tensor per call, and each step gathers its batch with
    ``index_select``.  The same arithmetic as ``sweep`` calls of
    :func:`make_train_step`'s step with one generator.

    Returns ``sweep_step(state, data, idx, generator) → (state, {"loss":
    [sweep]})`` with ``data = {"poses_3d": [N, J, 3], "poses_2d_gmm":
    [N, J, K, 5]}`` on the device.
    """
    base = base_step or make_train_step(model, optimizer, betas, impl=impl, ema_mu=ema_mu,
                                        device=device, dropout=dropout, tier=tier)

    def sweep_step(state: TrainState, data: dict, idx: torch.Tensor, generator: torch.Generator):
        if idx.shape[0] != sweep:
            raise ValueError(f"idx holds {idx.shape[0]} steps, the sweep was built for {sweep}")
        losses = []
        for ids in idx:
            batch = {k: data[k].index_select(0, ids) for k in ("poses_3d", "poses_2d_gmm")}
            state, metrics = base(state, batch, generator)
            losses.append(metrics["loss"])
        return state, {"loss": torch.stack(losses)}

    return sweep_step


EVAL_IMPLS = ("module", "fused")


@contextlib.contextmanager
def _swapped_in(model, params):
    """Run the body with ``model``'s parameters holding ``params``' values
    (the EMA shadow), then put the live values back."""
    if params is None:
        yield
        return
    live = {name: p.data for name, p in model.named_parameters()}
    try:
        for name, p in model.named_parameters():
            p.data = params[name]
        yield
    finally:
        for name, p in model.named_parameters():
            p.data = live[name]


def make_eval_step(diff_model, pose_model, betas, seq: Sequence[int], *, test_times: int = 1,
                   eta: float = 0.0, add_start_noise: bool = False, use_ema: bool = False,
                   gmm_base_seed: int = 0, impl: str = "module", device="cuda",
                   hyp_axis: Optional[MeshAxis] = None, tier: str = "bf16x3"):
    """Build the evaluation step (lift → DDIM loop → hypothesis mean).
    Counterpart of ``diffpose_tpu/train/steps.py:make_eval_step``.

    Reference protocol (``runners/diffpose_frame.py:330-391``): draw a GMM
    kernel for the 2D input, lift with GCNPose, root-centre, concatenate to
    uvxyz, replicate ``test_times`` hypotheses, run the (eta=0) DDIM
    subsequence *starting from the lifted uvxyz* (the noising line is
    disabled in the reference, ``:363``), average hypotheses, root-centre,
    and return per-sample P1/P2 errors.

    ``impl="fused"`` runs the lifter and the denoiser through the
    whole-network CUDA kernels of ``ops/fused_denoiser.py`` (on a CPU device:
    their plain versions); ``impl="module"`` through the ``nn.Module``
    forwards.  ``use_ema`` evaluates the EMA shadow instead of the live
    weights.  The GMM draw is keyed per sample by ``batch["seeds"]`` from a
    fixed base seed, so results do not depend on batch grouping.

    ``hyp_axis``: hypothesis parallelism (survey §2.6).  On one rank of a
    ``(data, hypothesis)`` mesh the step computes ``test_times / hyp_axis.size``
    hypotheses, draws its start noise and DDIM noise from the generator
    folded with its hypothesis coordinate, and the hypothesis mean is a sum
    over the axis's group divided by ``test_times``.  The deterministic
    protocol (no start noise, η=0: the reference eval) gives the same result
    at any split.

    Returns ``eval_step(state, pose_model, batch, generator, prepared=None)
    → (p1 [B], p2 [B], pred_xyz [B, J, 3])``, tensors on ``device``.
    ``eval_step.prepare(state, pose_model)`` stacks the weights of the
    models under evaluation once (``impl="fused"``), at the kernels' tier
    ``tier`` (``--kernel_precision``, ``fused_denoiser.tier_weights``); pass
    its result as ``prepared`` to every batch of one evaluation, or leave it
    out and the step prepares them itself.
    """
    if impl not in EVAL_IMPLS:
        raise ValueError(f"impl must be one of {EVAL_IMPLS}, got {impl!r}")
    device = resolve_device(device)
    seq = tuple(int(s) for s in seq)
    if hyp_axis is not None and test_times % hyp_axis.size:
        raise ValueError(f"test_times {test_times} does not split over {hyp_axis.size} "
                         "hypothesis ranks")
    tt_local = test_times // hyp_axis.size if hyp_axis is not None else test_times

    def ema_of(state):
        return state.ema_params if use_ema and state.ema_params is not None else None

    @torch.no_grad()
    def prepare(state, pose):
        if impl != "fused":
            return None
        with _swapped_in(state.model, ema_of(state)):
            diff_w = tier_weights(prepare_weights(state.model, device=device), tier)
        return tier_weights(prepare_weights(pose, device=device), tier), diff_w

    @torch.no_grad()
    def eval_step(state, pose, batch: dict, generator: Optional[torch.Generator] = None,
                  prepared=None):
        with span("step.eval"):
            return step_body(state, pose, batch, generator, prepared)

    def step_body(state, pose, batch, generator, prepared):
        if state.model is not diff_model:
            raise ValueError("the state holds another model than the step")
        pose = pose_model if pose is None else pose
        with span("step.inputs"):
            gmm = torch.as_tensor(batch["poses_2d_gmm"], device=device)
            poses_3d = torch.as_tensor(batch["poses_3d"], device=device)
            seeds = torch.as_tensor(batch["seeds"], device=device)
        with span("step.gmm"):
            _, noise_scale, input_2d = sample_gmm_batch_per_sample(gmm_base_seed, seeds, gmm,
                                                                   poses_3d)
        input_2d = input_2d.contiguous()      # a slice of the chosen kernels; the wrappers take no strides

        if impl == "fused":
            pose_w, diff_w = prepared if prepared is not None else prepare(state, pose)
            lift = functools.partial(fused_lifter, pose_w)
            denoise = functools.partial(fused_denoiser, diff_w)
            swap = contextlib.nullcontext()
        else:
            diff_model.eval()
            pose.eval()
            lift, denoise = pose, diff_model
            swap = _swapped_in(diff_model, ema_of(state))

        xyz = lift(input_2d)
        xyz = xyz - xyz[:, :1, :]
        uvxyz = torch.cat([input_2d, xyz], dim=-1).repeat(tt_local, 1, 1)
        if hyp_axis is not None and generator is not None and (add_start_noise or eta):
            generator = fold_in(generator, hyp_axis.index)
        if add_start_noise:
            e = torch.randn(uvxyz.shape, generator=generator, device=device,
                            dtype=uvxyz.dtype) * noise_scale.repeat(tt_local, 1, 1)
            t0 = torch.full((uvxyz.shape[0],), seq[-1], dtype=torch.int64, device=device)
            uvxyz = q_sample(uvxyz, t0, e, betas)
        with swap:
            out = ddim_sample(denoise, uvxyz, seq, betas, eta=eta, generator=generator)
        out = out.reshape(tt_local, -1, out.shape[1], out.shape[2])
        if hyp_axis is not None:
            # the hypothesis mean across the axis: local sum, then a sum over its group
            out = sum_over(out.sum(dim=0), hyp_axis) / test_times
        else:
            out = out.mean(dim=0)

        pred_xyz = out[..., 2:]
        pred_xyz = pred_xyz - pred_xyz[:, :1, :]
        target = poses_3d - poses_3d[:, :1, :]
        with span("metrics.errors"):
            return (mpjpe_per_sample(pred_xyz, target), p_mpjpe_per_sample(pred_xyz, target),
                    pred_xyz)

    eval_step.prepare = prepare
    return eval_step
