"""Frame eval pipeline: lift + DDIM denoise over the fused forwards.

The reference evaluation protocol (``runners/diffpose_frame.py:300-340`` +
``common/utils_diff.py:46-67``): GCNPose lifts the 2D keypoints, the
result is root-centred and joined to them as ``uvxyz``, tiled
``test_times`` times, run through the DDIM reverse loop with the GCNDiff
denoiser, and the hypotheses are averaged.  On the card the three network
forwards (1 lift + 2 denoise steps for ``seq=(0, 12)``) are one kernel
launch each; the small DDIM mixing between them is plain PyTorch.
Counterpart of ``diffpose_tpu/ops/pallas_pipeline.py:make_pallas_eval_fn``.
"""

from __future__ import annotations

import functools
from typing import Callable, Sequence

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


def lift_and_denoise(
    lift: Callable[[torch.Tensor], torch.Tensor],
    denoise: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
    x2d: torch.Tensor,
    *,
    seq: Sequence[int],
    betas,
    test_times: int,
) -> torch.Tensor:
    """``x2d [B, 17, 2] → xyz [B, 17, 3]``, the mean over ``test_times``
    hypotheses, with the given lifter and denoiser forwards."""
    xyz = lift(x2d)
    xyz = xyz - xyz[:, :1, :]
    uvxyz = torch.cat([x2d, xyz], dim=-1)
    uvxyz = uvxyz.repeat(test_times, 1, 1)  # the order of jnp.tile
    out = ddim_sample(denoise, uvxyz, seq, betas)
    return out.reshape(test_times, -1, x2d.shape[1], 5).mean(dim=0)[..., 2:]


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
        return lift_and_denoise(
            functools.partial(fused_lifter, at_tier(pose_weights, tier)),
            functools.partial(fused_denoiser, at_tier(diff_weights, tier)),
            x2d, seq=seq, betas=betas, test_times=test_times)

    return eval_one
