"""Train step functions of the frame family.

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
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from diffpose_tpu_torch.data.gmm import sample_gmm_batch
from diffpose_tpu_torch.diffusion.ddim import antithetic_timesteps, q_sample, q_sample_tables
from diffpose_tpu_torch.models.ema import ema_update
from diffpose_tpu_torch.ops.fused_denoiser import resolve_device
from diffpose_tpu_torch.ops.fused_train import build_train_stack, fused_train_forward
from diffpose_tpu_torch.ops.train_ref import DropoutMasks, make_dropout_masks, train_forward
from diffpose_tpu_torch.train.state import TrainState

IMPLS = ("fused", "plain", "module")


class StepDraws(NamedTuple):
    """Everything random in one step."""

    x_t: torch.Tensor                  # [B, J, 5] noised sample
    t: torch.Tensor                    # [B] int64 timesteps
    e: torch.Tensor                    # [B, J, 5] target noise, scaled per coordinate
    masks: Optional[DropoutMasks]      # None for impl="module" (nn.Dropout draws its own)


def diffusion_loss(eps: torch.Tensor, target_noise: torch.Tensor) -> torch.Tensor:
    return ((target_noise - eps) ** 2).sum(dim=(1, 2)).mean()


def make_train_step(model, optimizer, betas, *, impl: str = "fused",
                    ema_mu: Optional[float] = 0.999, device="cuda"):
    """Build ``train_step(state, batch, generator) → (state, metrics)``.

    ``impl``: ``"fused"`` runs the denoiser's layers through the CUDA
    kernel pair of ``ops/fused_train.py`` (on a CPU device: their plain
    versions); ``"plain"`` is ``train_ref.train_forward`` under autograd
    with the same explicit masks; ``"module"`` is ``GCNDiff.train()`` under
    autograd with ``nn.Dropout``, which draws from torch's default
    generator.  ``model`` lies on ``device``; ``generator`` is a
    ``torch.Generator`` of that device; ``optimizer`` is
    ``train.optim.make_optimizer``'s.  ``batch``: ``poses_3d [B, J, 3]`` and
    ``poses_2d_gmm [B, J, K, 5]``.  ``metrics``: ``loss`` and ``grad_norm``
    (the global norm before the clip), scalar tensors on ``device``.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    device = resolve_device(device)
    if next(model.parameters()).device.type != device.type:
        raise ValueError(f"the model lies on {next(model.parameters()).device}, not on {device}")
    num_timesteps = len(betas)
    tables = q_sample_tables(betas, torch.float32, device)
    cfg = dict(num_layers=model.num_layers, num_heads=model.num_heads, hid_dim=model.hid_dim)
    basis = model.gconv_input.basis.detach().cpu().numpy()
    stack_fn = build_train_stack(basis, **cfg) if impl == "fused" else None

    def draw(batch: dict, generator: torch.Generator) -> StepDraws:
        gmm = torch.as_tensor(batch["poses_2d_gmm"], device=device)
        uvxyz, noise_scale, _ = sample_gmm_batch(
            generator, gmm, torch.as_tensor(batch["poses_3d"], device=device))
        n, n_pts = uvxyz.shape[:2]
        t = antithetic_timesteps(generator, n, num_timesteps)
        e = torch.randn(uvxyz.shape, generator=generator, device=device,
                        dtype=uvxyz.dtype) * noise_scale
        x_t = q_sample(uvxyz, t, e, betas, tables)
        masks = None
        if impl != "module":
            masks = make_dropout_masks(
                generator, n_pts=n_pts, batch=n, **cfg,
                dtype=torch.uint8 if impl == "fused" else torch.float32)
        return StepDraws(x_t, t, e, masks)

    def apply(state: TrainState, draws: StepDraws):
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("the state holds another model or optimizer than the step")
        model.train()
        optimizer.zero_grad()
        t = draws.t.to(torch.float32)
        if impl == "fused":
            eps = fused_train_forward(model, draws.x_t, t, draws.masks, stack_fn)
        elif impl == "plain":
            eps = train_forward(model, draws.x_t, t, draws.masks)
        else:
            eps = model(draws.x_t, t)
        loss = diffusion_loss(eps, draws.e)
        loss.backward()
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
                          ema_mu: Optional[float] = 0.999, device="cuda",
                          base_step: Optional[Callable] = None):
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
                                        device=device)

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
