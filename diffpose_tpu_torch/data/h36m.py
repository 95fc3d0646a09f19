"""Human3.6M dataset loading (host-side, setup-time).

Capability parity with reference ``common/h36m_dataset.py`` +
``common/mocap_dataset.py``: loads the serialized ``data_3d_h36m.npz``
(``positions_3d[subject][action] → [frames, 32, 3]`` world-space meters),
attaches the hardcoded camera calibration (normalized), and removes the 15
static joints to produce the 17-joint skeleton with rewired shoulders.

Counterpart of ``diffpose_tpu/data/h36m.py`` (this package keeps its own copy).
"""

from __future__ import annotations

import copy
from typing import Dict, List, Optional

import numpy as np

from diffpose_tpu_torch.data.h36m_cameras import CAMERA_PARA, EXTRINSICS, INTRINSICS
from diffpose_tpu_torch.geometry.camera import normalize_screen_coordinates
from diffpose_tpu_torch.skeleton import Skeleton

TRAIN_SUBJECTS: tuple = ("S1", "S5", "S6", "S7", "S8")
TEST_SUBJECTS: tuple = ("S9", "S11")

# Raw 32-joint kinematic tree + left/right split (dataset metadata,
# reference common/h36m_dataset.py:10-13).
H36M_32_PARENTS = (
    -1, 0, 1, 2, 3, 4, 0, 6, 7, 8, 9, 0, 11, 12, 13, 14, 12,
    16, 17, 18, 19, 20, 19, 22, 12, 24, 25, 26, 27, 28, 27, 30,
)
H36M_32_LEFT = (6, 7, 8, 9, 10, 16, 17, 18, 19, 20, 21, 22, 23)
H36M_32_RIGHT = (1, 2, 3, 4, 5, 24, 25, 26, 27, 28, 29, 30, 31)
# Indices of the 17 moving joints (the non-empty H36M_NAMES slots).
H36M_MOVING_JOINTS = (0, 1, 2, 3, 6, 7, 8, 12, 13, 14, 15, 17, 18, 19, 25, 26, 27)
H36M_JOINTS_GROUP = ((2, 3), (5, 6), (1, 4), (0, 7), (8, 9), (14, 15), (11, 12), (10, 13))

ALL_ACTIONS = (
    "Directions", "Discussion", "Eating", "Greeting", "Phoning", "Photo",
    "Posing", "Purchases", "Sitting", "SittingDown", "Smoking", "Waiting",
    "WalkDog", "Walking", "WalkTogether",
)


def _normalized_cameras() -> Dict[str, List[dict]]:
    """Merge extrinsics + intrinsics; normalize center/focal; mm → m."""
    cameras: Dict[str, List[dict]] = {}
    for subject, ext_cams in EXTRINSICS.items():
        cams = []
        for i, ext in enumerate(ext_cams):
            cam = copy.deepcopy(dict(INTRINSICS[i]))
            cam.update({k: np.array(v, dtype=np.float32) for k, v in ext.items()})
            for key in ("center", "focal_length", "radial_distortion", "tangential_distortion"):
                cam[key] = np.asarray(cam[key], np.float32)
            cam["center"] = normalize_screen_coordinates(
                cam["center"], w=cam["res_w"], h=cam["res_h"]
            ).astype(np.float32)
            cam["focal_length"] = cam["focal_length"] / cam["res_w"] * 2.0
            cam["translation"] = cam["translation"] / 1000.0  # mm → m
            cam["intrinsic"] = np.concatenate(
                [
                    cam["focal_length"],
                    cam["center"],
                    cam["radial_distortion"],
                    cam["tangential_distortion"],
                ]
            ).astype(np.float32)
            cams.append(cam)
        cameras[subject] = cams
    return cameras


class Human36mDataset:
    """3D pose dataset keyed ``[subject][action]`` with camera metadata."""

    fps = 50

    def __init__(self, path: str, remove_static_joints: bool = True):
        self._skeleton = Skeleton(
            H36M_32_PARENTS, list(H36M_32_LEFT), list(H36M_32_RIGHT)
        )
        self._cameras = _normalized_cameras()

        data = np.load(path, allow_pickle=True)["positions_3d"].item()
        self._data: Dict[str, Dict[str, dict]] = {}
        for subject, actions in data.items():
            self._data[subject] = {}
            for action_name, positions in actions.items():
                self._data[subject][action_name] = {
                    "positions": positions,
                    "cameras": self._cameras[subject],
                }

        if remove_static_joints:
            removed = [j for j in range(32) if j not in H36M_MOVING_JOINTS]
            self.remove_joints(removed)
            # Rewire the shoulders to the thorax (reference
            # common/h36m_dataset.py:276-278).
            self._skeleton._parents[11] = 8
            self._skeleton._parents[14] = 8
            self._skeleton._joints_group = H36M_JOINTS_GROUP

    # -- MocapDataset-style surface (reference common/mocap_dataset.py:4-35) --

    def __getitem__(self, subject: str):
        return self._data[subject]

    def subjects(self):
        return self._data.keys()

    def cameras(self):
        return self._cameras

    def skeleton(self) -> Skeleton:
        return self._skeleton

    def remove_joints(self, joints_to_remove):
        kept = self._skeleton.remove_joints(joints_to_remove)
        for subject in self._data.keys():
            for action in self._data[subject].keys():
                s = self._data[subject][action]
                s["positions"] = s["positions"][:, kept]

    @staticmethod
    def define_actions(action: Optional[str] = None):
        if action is None:
            return list(ALL_ACTIONS)
        if action not in ALL_ACTIONS:
            raise ValueError(f"Undefined action: {action}")
        return [action]


def camera_para_for_id(camera_id: str) -> np.ndarray:
    """Normalized (f_x, f_y, c_x, c_y) conditioning vector for a camera id."""
    return np.asarray(CAMERA_PARA[camera_id], np.float32)
