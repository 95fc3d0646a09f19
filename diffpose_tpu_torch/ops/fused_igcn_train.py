"""Implicit (IGCN) training with the layer stack's forward and backward as the
CUDA kernel pair, once per solver iteration.  Counterpart of
``diffpose_tpu/ops/pallas_igcn_train.py``.

The training forward is the fixed-point solve ``z* = f(z*)`` with
``f(z) = BatchNorm(stack(z))`` in training mode (dropout on, batch
statistics), differentiated straight through a fixed count of iterations
(``models/solvers.py``, ``differentiable=True``): every iteration pays a
stack forward and its backward.  Each iteration's stack is the autograd
function of ``ops/fused_train.py:build_train_stack`` over the train kernels
(rows 5–6 with explicit masks, rows 7–8 seeded): with Anderson at the
defaults a step launches each kernel ``1 + max_iterations`` times.
Everything around them is plain PyTorch under autograd: the weight prep, the
timestep MLP, the input and output ChebConvs, the train BatchNorm over
``[B·17, 96]``, the solver's mixing.

Dropout: one mask set, or one seed, per step, reused by every iteration, as
the flax module draws each site's mask once per traced call.

``remat=True`` wraps each iteration in ``torch.utils.checkpoint``
(non-reentrant): its stashes (about 167 MB an iteration at B=512) are not
kept across the solve but rebuilt in the backward by a second forward
launch, the counterpart of ``jax.checkpoint`` (``pallas_igcn_train.py:161-162``).
"""

from __future__ import annotations

from typing import Optional

from diffpose_tpu_torch.models.igcn import IGCN
from diffpose_tpu_torch.ops.fused_denoiser import prepare_weights
from diffpose_tpu_torch.ops.fused_train import build_train_stack

__all__ = ["make_igcn_train_fn", "make_fused_implicit_train_step"]


def make_igcn_train_fn(model: IGCN, *, dropout: str = "prng", remat: bool = False,
                       stack=None):
    """Build ``fn(x, t, masks_or_seed, z0=None, z0_weight=None,
    tolerance_override=None) → (out, aux, running)``, the fused training
    forward of ``model`` (its parameters under autograd).

    ``masks_or_seed``: with ``dropout="prng"`` the step's ``int32[1]`` seed
    on the inputs' device, with ``"masks"`` a ``DropoutMasks``.  ``aux``:
    ``iterations`` (an int32 tensor), ``residual``, ``fixed_point`` (and
    ``alpha``, damped); ``running``: the BatchNorm's running buffers after
    this step, which the caller writes.  ``stack(w, h0, tp, masks_or_seed)``
    replaces the kernel pair (the tests' plain twin).
    """
    basis = model.gconv_input.basis.detach().cpu().numpy()
    stack_fn = stack or build_train_stack(basis, num_layers=model.num_layers,
                                          num_heads=model.num_heads, hid_dim=model.hid_dim,
                                          dropout=dropout)

    def fn(x, t, masks_or_seed, z0=None, z0_weight=None,
           tolerance_override: Optional[float] = None):
        w = prepare_weights(model, device=x.device, differentiable=True)
        return model.train_solve(w, x, t, stack_fn, masks_or_seed, z0=z0, z0_weight=z0_weight,
                                 tolerance_override=tolerance_override, remat=remat)

    return fn


def make_fused_implicit_train_step(model, optimizer, betas, **kwargs):
    """The fused drop-in for the module implicit train step:
    ``train.implicit_steps.make_implicit_train_step(impl="fused")``, the same
    signature and metrics."""
    from diffpose_tpu_torch.train import implicit_steps

    return implicit_steps.make_implicit_train_step(model, optimizer, betas, impl="fused",
                                                   **kwargs)
