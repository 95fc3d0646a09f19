"""The benchmark's inputs, made from the run's seed.

The port's synthetic H3.6M generator
(``diffpose_tpu_torch/data/synthetic.py:make_synthetic_dataset``), kept
here so that no later change to the program can change what the benchmark
feeds it, and drawn in bulk on the device instead of row by row on the
host: random bone directions on the 17-joint skeleton with H3.6M bone
lengths, pinhole-projected, each joint wrapped in ``n_kernels`` GMM kernels
(Dirichlet(1) weights, means jittered around the projection, variances
uniform in [0.5, 2] x the jitter).  The drivers wrap the numpy arrays in the
program's dataset types.
"""

from __future__ import annotations

import numpy as np
import torch

H36M_EDGES = (
    (0, 1), (1, 2), (2, 3),
    (0, 4), (4, 5), (5, 6),
    (0, 7), (7, 8), (8, 9), (9, 10),
    (8, 11), (11, 12), (12, 13),
    (8, 14), (14, 15), (15, 16),
)
# Approximate H3.6M bone lengths in metres, in the order of H36M_EDGES.
BONE_LENGTHS = (
    0.13, 0.45, 0.45, 0.13, 0.45, 0.45, 0.24, 0.25, 0.12, 0.12,
    0.15, 0.28, 0.25, 0.15, 0.28, 0.25,
)
ACTIONS = (
    "Directions", "Discussion", "Eating", "Greeting", "Phoning", "Photo",
    "Posing", "Purchases", "Sitting", "SittingDown", "Smoking", "Waiting",
    "WalkDog", "Walking", "WalkTogether",
)


def frames(num_frames: int, seed: int, n_kernels: int = 5, noise_2d: float = 0.01,
           device="cpu") -> dict:
    """``num_frames`` frames: ``poses_3d [F, 17, 3]`` (root-centred, metres),
    ``poses_2d_gmm [F, 17, K, 5]`` (weight, mean u, v, variance u, v),
    ``action_ids [F]`` into :data:`ACTIONS`, ``camera_para [F, 4]``; numpy
    arrays, drawn in bulk by a ``torch.Generator`` on ``device``."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=device, dtype=torch.float64)

    def uniform(*shape):
        return torch.rand(shape, generator=gen, device=device, dtype=torch.float64)

    directions = normal(num_frames, len(H36M_EDGES), 3)
    directions = directions / directions.norm(dim=-1, keepdim=True)
    joints = [torch.zeros((num_frames, 3), dtype=torch.float64, device=device)] * 17
    for e, (parent, child) in enumerate(H36M_EDGES):
        joints[child] = joints[parent] + BONE_LENGTHS[e] * directions[:, e]
    poses = torch.stack(joints, dim=1).float()
    cam_pose = poses + torch.tensor([0.0, 0.0, 4.5], device=device)
    uv = cam_pose[..., :2] / cam_pose[..., 2:]
    expo = -torch.log1p(-uniform(num_frames, 17, n_kernels))      # Dirichlet(1, ..., 1)
    weights = (expo / expo.sum(dim=-1, keepdim=True)).float()
    means = uv[:, :, None, :] + (noise_2d * normal(num_frames, 17, n_kernels, 2)).float()
    variances = (noise_2d * (0.5 + 1.5 * uniform(num_frames, 17, n_kernels, 2))).float()
    gmm = torch.cat([weights[..., None], means, variances], dim=-1)
    action_ids = torch.randint(0, len(ACTIONS), (num_frames,), generator=gen, device=device,
                               dtype=torch.int32)
    camera_para = torch.tensor([2.29, 2.2876, 0.025, 0.029]).repeat(num_frames, 1)
    return dict(poses_3d=(poses - poses[:, :1, :]).cpu().numpy(), poses_2d_gmm=gmm.cpu().numpy(),
                action_ids=action_ids.cpu().numpy(), camera_para=camera_para.numpy())
