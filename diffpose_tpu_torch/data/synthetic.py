"""Synthetic H3.6M-shaped data for tests, smoke runs and benchmarks.

The real dataset files are not distributable with the repository; this
module fabricates geometrically plausible data in the same flat format:
random bone poses on the 17-joint skeleton, pinhole-projected to 2D,
wrapped in ``n_kernels`` GMM kernels with small jitter.  Counterpart of
``diffpose_tpu/data/synthetic.py``: the same numpy random stream, so the
arrays are equal to that package's for equal arguments.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from diffpose_tpu_torch.data.h36m import ALL_ACTIONS
from diffpose_tpu_torch.data.pipeline import FlatDataset  # noqa: F401  (re-exported)
from diffpose_tpu_torch.graph import H36M_EDGES

# Approximate H3.6M bone lengths in metres, in the order of H36M_EDGES.
_BONE_LENGTHS = (
    0.13, 0.45, 0.45, 0.13, 0.45, 0.45, 0.24, 0.25, 0.12, 0.12,
    0.15, 0.28, 0.25, 0.15, 0.28, 0.25,
)


def make_synthetic_dataset(
    num_frames: int = 2048,
    n_kernels: int = 5,
    seed: int = 0,
    noise_2d: float = 0.01,
    pose_modes: Optional[int] = None,
) -> FlatDataset:
    """``pose_modes=None`` draws i.i.d. random bone directions; single-frame
    lifting is then depth-ambiguous by construction.  ``pose_modes=K``
    clusters the poses around K prototype direction sets (small jitter),
    the well-posed regime of real mocap.  The prototypes come from a fixed
    stream keyed only by ``pose_modes``, so differently seeded splits share
    one pose manifold."""
    rng = np.random.default_rng(seed)
    n_edges = len(H36M_EDGES)
    if pose_modes:
        proto_rng = np.random.default_rng(19_690_720 + pose_modes)
        protos = proto_rng.normal(size=(pose_modes, n_edges, 3))
        protos /= np.linalg.norm(protos, axis=-1, keepdims=True)
        assign = rng.integers(0, pose_modes, size=num_frames)
        directions = protos[assign] + 0.08 * rng.normal(size=(num_frames, n_edges, 3))
    else:
        directions = rng.normal(size=(num_frames, n_edges, 3))
    directions /= np.linalg.norm(directions, axis=-1, keepdims=True)
    poses = np.zeros((num_frames, 17, 3), np.float32)
    for e, (parent, child) in enumerate(H36M_EDGES):
        poses[:, child] = poses[:, parent] + _BONE_LENGTHS[e] * directions[:, e]

    # Camera space: push away from the camera and pinhole-project.
    cam_pose = poses + np.array([0.0, 0.0, 4.5], np.float32)
    uv = cam_pose[..., :2] / cam_pose[..., 2:]

    # GMM kernels around the projected uv with jitter; Dirichlet weights.
    weights = rng.dirichlet(np.ones(n_kernels), size=(num_frames, 17)).astype(np.float32)
    means = (uv[:, :, None, :]
             + rng.normal(scale=noise_2d, size=(num_frames, 17, n_kernels, 2))).astype(np.float32)
    variances = rng.uniform(
        0.5 * noise_2d, 2.0 * noise_2d, size=(num_frames, 17, n_kernels, 2)).astype(np.float32)
    gmm = np.concatenate([weights[..., None], means, variances], axis=-1)

    action_ids = rng.integers(0, len(ALL_ACTIONS), size=num_frames).astype(np.int32)
    camera_para = np.tile(np.asarray([2.29, 2.2876, 0.025, 0.029], np.float32), (num_frames, 1))
    poses = poses - poses[:, :1, :]
    return FlatDataset(poses, gmm, action_ids, camera_para, ALL_ACTIONS)
