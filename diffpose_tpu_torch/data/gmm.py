"""GMM keypoint-distribution sampling on the device.

The reference draws one GMM kernel per joint per frame on the host with
``np.random.choice`` inside a DataLoader worker
(``common/generators.py:36-38``).  Here the draw is one vectorized
categorical draw over the kernel weights, from an explicit
``torch.Generator``, on the tensors' device.  Counterpart of
``diffpose_tpu/data/gmm.py``.

Each function takes an optional ``choice`` (``[B, J]`` kernel indices): the
draw is then skipped and the sample assembled from the given kernels.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

Triple = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def draw_gmm_choice(generator: torch.Generator, poses_2d_gmm: torch.Tensor) -> torch.Tensor:
    """One kernel index per (frame, joint), ``[B, J]`` int64, drawn with
    probability proportional to ``max(weight, 1e-12)``: the categorical
    distribution over the logits ``log(max(w, 1e-12))``."""
    b, j, k, _ = poses_2d_gmm.shape
    w = poses_2d_gmm[..., 0].clamp_min(1e-12).reshape(b * j, k)
    return torch.multinomial(w, 1, generator=generator).reshape(b, j)


def assemble_gmm_sample(poses_2d_gmm: torch.Tensor, poses_3d: torch.Tensor,
                        choice: torch.Tensor) -> Triple:
    """``(uvxyz, noise_scale, pose_2d)`` from the chosen kernels (reference
    sample assembly, ``common/generators.py:40-45``)."""
    assert poses_2d_gmm.shape[-1] == 5
    idx = choice[..., None, None].expand(-1, -1, 1, 5)
    kernel = torch.gather(poses_2d_gmm, 2, idx)[:, :, 0, :]  # [B, J, 5]
    mean_uv, var_uv = kernel[..., 1:3], kernel[..., 3:5]
    uvxyz = torch.cat([mean_uv, poses_3d], dim=-1)
    noise_scale = torch.cat([var_uv, torch.ones_like(poses_3d)], dim=-1)
    return uvxyz, noise_scale, mean_uv


def sample_gmm_batch(generator: Optional[torch.Generator], poses_2d_gmm: torch.Tensor,
                     poses_3d: torch.Tensor, choice: Optional[torch.Tensor] = None) -> Triple:
    """Draw per-joint GMM kernels and assemble the training sample.

    ``poses_2d_gmm``: ``[B, J, K, 5]`` with kernel = [weight, mean_u, mean_v,
    var_u, var_v]; ``poses_3d``: ``[B, J, 3]`` (root-centred).  Returns

    * ``uvxyz``       ``[B, J, 5]`` — the selected kernel's mean uv ∥ xyz
    * ``noise_scale`` ``[B, J, 5]`` — [var_u, var_v, 1, 1, 1]
    * ``pose_2d``     ``[B, J, 2]`` — the selected kernel means
    """
    if choice is None:
        choice = draw_gmm_choice(generator, poses_2d_gmm)
    return assemble_gmm_sample(poses_2d_gmm, poses_3d, choice)


def _hash_uniform(x: torch.Tensor) -> torch.Tensor:
    """A 32-bit integer mix of int64 ``x`` (two multiply-xorshift rounds),
    as float32 uniforms in [0, 1)."""
    m = 0xFFFFFFFF
    x = x & m
    x = ((x ^ (x >> 16)) * 0x7FEB352D) & m
    x = ((x ^ (x >> 15)) * 0x846CA68B) & m
    x = x ^ (x >> 16)
    return (x >> 8).to(torch.float32) * (1.0 / (1 << 24))


def sample_gmm_batch_per_sample(base_seed: int, seeds: torch.Tensor, poses_2d_gmm: torch.Tensor,
                                poses_3d: torch.Tensor,
                                choice: Optional[torch.Tensor] = None) -> Triple:
    """Per-sample-keyed GMM draw: each sample's kernels depend only on
    ``(base_seed, seeds[i])``, not on the batch it arrives in, so a dataset
    evaluated in any batching or sharding draws the same kernels.

    The JAX package folds ``seeds[i]`` into a key; here a counter-based
    hash of ``(base_seed, seeds[i], joint)`` gives one uniform per joint,
    which picks the kernel by the inverse CDF of the weights.  The bits
    differ from the JAX draw, the distribution does not.
    """
    if choice is None:
        b, j, k, _ = poses_2d_gmm.shape
        joint = torch.arange(j, device=seeds.device, dtype=torch.int64)
        counter = (seeds.to(torch.int64)[:, None] * 1_000_003 + joint[None, :]) ^ (
            int(base_seed) * 0x9E3779B1)
        u = _hash_uniform(counter)  # [B, J]
        w = poses_2d_gmm[..., 0].clamp_min(1e-12)
        cdf = torch.cumsum(w, dim=-1)
        cdf = cdf / cdf[..., -1:]
        choice = (u[..., None] >= cdf).sum(dim=-1).clamp_max(k - 1)
    return assemble_gmm_sample(poses_2d_gmm, poses_3d, choice)


def gmm_mean_pose_2d(poses_2d_gmm: torch.Tensor) -> torch.Tensor:
    """Weight-averaged 2D pose (the distribution mean), ``[B, J, 2]``."""
    w = poses_2d_gmm[..., 0:1]
    return (w * poses_2d_gmm[..., 1:3]).sum(dim=2) / w.sum(dim=2).clamp_min(1e-12)
