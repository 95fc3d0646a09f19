"""Camera-frame transforms for the Human3.6M pipeline.

Host-side numpy versions of screen normalization and world↔camera
transforms (setup-time, matching reference ``common/camera.py:10-30``), and
torch versions of the H3.6M distortion projection model (reference
``common/camera.py:33-88``) for on-device, differentiable use.  Counterpart
of ``diffpose_tpu/geometry/camera.py``.
"""

from __future__ import annotations

import numpy as np
import torch

from diffpose_tpu_torch.geometry.quaternion import qrot, qinverse


def normalize_screen_coordinates(x, w, h):
    """Map pixel coords so [0, w] → [−1, 1], preserving aspect ratio."""
    x = np.asarray(x)
    assert x.shape[-1] == 2
    return x / w * 2.0 - np.array([1.0, h / w])


def image_coordinates(x, w, h):
    """Inverse of :func:`normalize_screen_coordinates`."""
    x = np.asarray(x)
    assert x.shape[-1] == 2
    return (x + np.array([1.0, h / w])) * w / 2.0


def world_to_camera(x, rotation, translation):
    """World → camera: rotate by the inverse quaternion after translating."""
    x = np.asarray(x)
    q = np.broadcast_to(qinverse(rotation), x.shape[:-1] + (4,))
    return qrot(q, x - translation)


def camera_to_world(x, rotation, translation):
    x = np.asarray(x)
    q = np.broadcast_to(np.asarray(rotation), x.shape[:-1] + (4,))
    return qrot(q, x) + translation


def project_to_2d(points_3d, intrinsics):
    """Project camera-space 3D points through the full H3.6M lens model.

    ``intrinsics`` is ``(N, 9)``: focal(2) | center(2) | radial k(3) |
    tangential p(2).  Differentiable torch; matches the reference math
    (``common/camera.py:33-64``) including the ±1 clamp on the normalized
    image coordinates.
    """
    x = torch.as_tensor(points_3d)
    cam = torch.as_tensor(intrinsics, device=x.device)
    assert x.shape[-1] == 3 and cam.shape[-1] == 9
    while cam.ndim < x.ndim:
        cam = cam[:, None]

    f, c, k, p = cam[..., :2], cam[..., 2:4], cam[..., 4:7], cam[..., 7:]
    xx = torch.clamp(x[..., :2] / x[..., 2:], -1.0, 1.0)
    r2 = (xx ** 2).sum(dim=-1, keepdim=True)
    radial = 1.0 + (k * torch.cat([r2, r2 ** 2, r2 ** 3], dim=-1)).sum(dim=-1, keepdim=True)
    tan = (p * xx).sum(dim=-1, keepdim=True)
    xxx = xx * (radial + tan) + p * r2
    return f * xxx + c


def project_to_2d_linear(points_3d, intrinsics):
    """Pinhole-only projection (focal + principal point)."""
    x = torch.as_tensor(points_3d)
    cam = torch.as_tensor(intrinsics, device=x.device)
    assert x.shape[-1] == 3 and cam.shape[-1] == 9
    while cam.ndim < x.ndim:
        cam = cam[:, None]
    f, c = cam[..., :2], cam[..., 2:4]
    xx = torch.clamp(x[..., :2] / x[..., 2:], -1.0, 1.0)
    return f * xx + c
