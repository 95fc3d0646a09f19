"""Implicit (IGCN) eval forward with the layer stack as one CUDA kernel launch
per solver iteration.  Counterpart of ``diffpose_tpu/ops/pallas_igcn.py``.

The eval forward is the fixed-point solve ``z* = f(z*)`` with
``f(z) = BatchNorm(stack(z))``.  The solve runs 10–20 iterations of the
5-layer stack, the hottest loop of the implicit family, so the stack runs as
the bare-stack build of the whole-network kernel (kernel row 3,
``ops/fused_denoiser.py:fused_backbone``): with Anderson one launch before
the loop and one after each body that moved ``z`` (a stalled body reuses
``f(z)``: 3 launches in a solve of 10 bodies at m=5), ``iterations`` with
the damped solver.  The Anderson solver's body runs as four kernel launches
(kernel row 14, ``ops/fused_anderson.py``).  Around them, in plain
PyTorch: the timestep MLP and its per-layer projections, the input and
output ChebConvs, the eval BatchNorm, the damped solver's relaxation, and
the host's reads: Anderson's of each body's stall and, from
``min_iterations`` on, its convergence test, once per body; the damped
solver's of the test, once per iteration from ``min_iterations`` on
(``models/solvers.py``).

Semantics are ``IGCN.forward`` in eval mode with ``differentiable=False``.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from diffpose_tpu_torch.models.igcn import IGCN, bn_eval, bn_state, warm_start
from diffpose_tpu_torch.ops.fused_denoiser import (
    Weights,
    _cheb,
    at_tier,
    fused_backbone,
    resolve_device,
    timestep_projections,
)
from diffpose_tpu_torch.ops.tf32 import PARITY_TIER, check_tier

__all__ = ["make_igcn_fn"]


def make_igcn_fn(model: IGCN, device="cuda", backbone: Optional[Callable] = None, *,
                 tier: str = PARITY_TIER):
    """Build ``fn(w, bn, x, t, z0=None, z0_weight=None, tolerance_override=None)
    → (out, aux)``, the fused equivalent of ``model.eval()(x, t, z0=...,
    z0_weight=..., differentiable=False)``.

    ``w``: ``prepare_weights(model)`` (made once per evaluation); ``bn``: the
    BatchNorm's parameters and running buffers, a dict as
    ``models/igcn.py:bn_state`` gives or the module itself.  The solver's
    configuration is ``model``'s.  ``aux`` holds ``iterations`` (a Python
    int), ``residual``, ``fixed_point`` and, damped, ``alpha``.

    ``device="cuda"`` (the default) raises without a card; the inputs' device
    decides what runs: the kernel on the card, its plain version on the CPU.
    ``backbone(w, z, tp)`` replaces :func:`fused_backbone` (the plain twin:
    ``fused_denoiser.backbone_plain``).  ``tier``: the stack's
    ``--kernel_precision`` (``fused_denoiser.tier_weights(..., ends=False)``:
    ``w`` made at the tier once by the caller, or rounded here at every
    call); the input and output ChebConvs, the BatchNorm and the solver stay
    f32, as in the JAX package.
    """
    resolve_device(device)
    check_tier(tier)
    stack = backbone or fused_backbone

    @torch.no_grad()
    def fn(w: Weights, bn, x: torch.Tensor, t: torch.Tensor, z0=None, z0_weight=None,
           tolerance_override=None):
        if isinstance(bn, IGCN):
            bn = bn_state(bn)
        w = at_tier(w, tier, ends=False)   # the ChebConvs below stay f32
        basis = w["basis"]
        tp = timestep_projections(w, t.to(torch.float32))
        z = warm_start(_cheb(x.to(torch.float32), w["win"], w["bin"], basis), z0, z0_weight)
        tol = model.tolerance if tolerance_override is None else tolerance_override
        z_star, aux, _ = model.solve(lambda zz: (bn_eval(stack(w, zz.contiguous(), tp), bn), None),
                                     z, tol, differentiable=False)
        return _cheb(z_star, w["wout"], w["bout"], basis), {**aux, "fixed_point": z_star}

    return fn
