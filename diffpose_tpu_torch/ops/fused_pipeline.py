"""The eval protocol of the frame and implicit families, and the frame
pipeline over the fused forwards.

The reference evaluation protocol (``runners/diffpose_frame.py:300-340`` +
``common/utils_diff.py:46-67``; ``runners/implicit_pose.py:523-531``): GCNPose
lifts the 2D keypoints, the result is root-centred and joined to them as
``uvxyz``, tiled ``test_times`` times, run through the family's sampler (the
DDIM reverse loop with the GCNDiff denoiser, or one fixed-point solve of the
IGCN), and the hypotheses are averaged.  :func:`lift_sample_mean` is that
protocol, the one copy both families' eval steps (``train/steps.py``,
``train/implicit_steps.py``) and :func:`make_eval_fn` run.  On the card the
three network forwards of a frame eval (1 lift + 2 denoise steps for
``seq=(0, 12)``) are one kernel launch each; the small DDIM mixing between
them is plain PyTorch.
Counterpart of ``diffpose_tpu/ops/pallas_pipeline.py:make_pallas_eval_fn``.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from diffpose_tpu_torch.diffusion import ddim_sample
from diffpose_tpu_torch.ops.fused_denoiser import (
    Weights,
    at_tier,
    fused_denoiser,
    fused_lifter,
    resolve_device,
)
from diffpose_tpu_torch.ops.tf32 import PARITY_TIER, check_tier
from diffpose_tpu_torch.parallel.mesh import MeshAxis
from diffpose_tpu_torch.parallel.sharding import sum_over


def lift_sample_mean(
    lift: Callable[[torch.Tensor], torch.Tensor],
    sample: Callable[[torch.Tensor], Tuple[torch.Tensor, Any]],
    x2d: torch.Tensor,
    *,
    test_times: int,
    hyp_axis: Optional[MeshAxis] = None,
) -> Tuple[torch.Tensor, Any]:
    """``x2d [B, J, 2] → (mean [B, J, 5], aux)``: lift, root-centre, join to
    ``uvxyz``, tile the hypotheses, ``sample(uvxyz) → (x, aux)`` (the family's
    sampler), and the mean over the hypotheses.  ``hyp_axis``: this rank holds
    ``test_times / hyp_axis.size`` of them, and the mean is a sum over the
    axis's group divided by ``test_times``."""
    local = test_times // hyp_axis.size if hyp_axis is not None else test_times
    xyz = lift(x2d)
    xyz = xyz - xyz[:, :1, :]
    uvxyz = torch.cat([x2d, xyz], dim=-1).repeat(local, 1, 1)   # the order of jnp.tile
    out, aux = sample(uvxyz)
    out = out.reshape(local, -1, out.shape[1], out.shape[2])
    if hyp_axis is not None:
        return sum_over(out.sum(dim=0), hyp_axis) / test_times, aux
    return out.mean(dim=0), aux


def make_eval_fn(basis: np.ndarray, *, seq: Sequence[int], betas, test_times: int = 1,
                 device="cuda", tier: str = PARITY_TIER):
    """Build ``eval_one(pose_weights, diff_weights, x2d) → xyz [B, 17, 3]``.

    The weights come from :func:`~diffpose_tpu_torch.ops.fused_denoiser.prepare_weights`
    of a GCNPose and a GCNDiff built on ``basis``; ``x2d`` is moved to
    ``device``.  On a CUDA device each forward is one kernel launch; with
    ``device="cpu"`` the plain PyTorch versions run.  ``tier``: the kernels'
    ``--kernel_precision`` (``fused_denoiser.tier_weights``: weights made at
    the tier once by the caller, or rounded here at every call).
    """
    device = resolve_device(device)
    check_tier(tier)
    basis = np.asarray(basis, np.float32)
    seq = tuple(int(s) for s in seq)
    betas = np.asarray(betas, np.float64)

    def eval_one(pose_weights: Weights, diff_weights: Weights, x2d) -> torch.Tensor:
        for w in (pose_weights, diff_weights):
            if not np.array_equal(w["basis_host"], basis):
                raise ValueError("weights were prepared for another Chebyshev basis")
        x2d = torch.as_tensor(x2d, dtype=torch.float32, device=device)
        lift = functools.partial(fused_lifter, at_tier(pose_weights, tier))
        denoise = functools.partial(fused_denoiser, at_tier(diff_weights, tier))
        out, _ = lift_sample_mean(
            lift, lambda uvxyz: (ddim_sample(denoise, uvxyz, seq, betas), ()), x2d,
            test_times=test_times)
        return out[..., 2:]

    return eval_one
