"""The video cells' inputs: windows of synthetic motion, made from the run's seed.

``data.frames``'s skeleton and GMM wrapping over windows of consecutive
frames, drawn in bulk on the device: each bone's direction is a fixed draw
of its window plus a sway of its own amplitude, period (30-120 frames, a
second or two at 50 fps) and phase, normalised, so that joints move
smoothly from frame to frame as a filmed body does; each joint of each
frame is wrapped in ``n_kernels`` GMM kernels around its projection.
The drivers wrap the numpy arrays in the program's ``VideoDataset``.
"""

from __future__ import annotations

import math

import torch

from portbench.harness.data import ACTIONS, BONE_LENGTHS, H36M_EDGES


def windows(num_windows: int, frames: int, seed: int, n_kernels: int = 5, noise_2d: float = 0.01,
            device="cpu") -> dict:
    """``poses_3d [W, F, 17, 3]`` (root-centred, metres), ``poses_2d_gmm [W,
    F, 17, K, 5]`` (weight, mean u, v, variance u, v), ``action_ids [W]`` into
    ``data.ACTIONS``; numpy arrays."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    w, e = num_windows, len(H36M_EDGES)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float64)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=device, dtype=torch.float64)

    base, sway = normal(w, 1, e, 3), 0.5 * normal(w, 1, e, 3)
    period = 30.0 + 90.0 * uniform(w, 1, e, 1)
    phase = 2 * math.pi * uniform(w, 1, e, 1)
    f = torch.arange(frames, device=device, dtype=torch.float64)[None, :, None, None]
    directions = base + sway * torch.sin(2 * math.pi * f / period + phase)     # [W, F, E, 3]
    directions = directions / directions.norm(dim=-1, keepdim=True)
    joints = [torch.zeros((w, frames, 3), dtype=torch.float64, device=device)] * 17
    for k, (parent, child) in enumerate(H36M_EDGES):
        joints[child] = joints[parent] + BONE_LENGTHS[k] * directions[:, :, k]
    poses = torch.stack(joints, dim=2).float()
    uv = (poses[..., :2] / (poses[..., 2:] + 4.5))
    expo = -torch.log1p(-uniform(w, frames, 17, n_kernels))      # Dirichlet(1, ..., 1)
    weights = (expo / expo.sum(dim=-1, keepdim=True)).float()
    means = uv[..., None, :] + (noise_2d * normal(w, frames, 17, n_kernels, 2)).float()
    variances = (noise_2d * (0.5 + 1.5 * uniform(w, frames, 17, n_kernels, 2))).float()
    gmm = torch.cat([weights[..., None], means, variances], dim=-1)
    action_ids = torch.randint(0, len(ACTIONS), (w,), generator=gen, device=device,
                               dtype=torch.int32)
    return dict(poses_3d=(poses - poses[..., :1, :]).cpu().numpy(),
                poses_2d_gmm=gmm.cpu().numpy(), action_ids=action_ids.cpu().numpy())
