"""Dataset preparation: world→camera 3D, 2D GMM keypoints, flattening.

Host-side, setup-time numpy (runs once per job).  Mirrors the reference
pipeline (``common/data_utils.py``) but ends in *flat contiguous arrays*
(frames × joints × …) instead of ragged per-sequence python lists, the
shape a device input pipeline wants.  Counterpart of
``diffpose_tpu/data/pipeline.py`` (numpy only; this package keeps its own copy).

2D GMM npz format (reference ``common/data_utils.py:65-87``)::

    positions_2d[subject][action][cam] → [frames, 17, n_kernels, 5]
    kernel = [weight, mean_u, mean_v, var_u, var_v]

with the kernel means screen-normalized at load.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import numpy as np

from diffpose_tpu_torch.data.h36m import Human36mDataset, camera_para_for_id
from diffpose_tpu_torch.geometry.camera import normalize_screen_coordinates, world_to_camera


def read_3d_data(dataset: Human36mDataset) -> Human36mDataset:
    """Attach per-camera camera-space 3D positions and camera_para vectors.

    Equivalent to ``read_3d_data_me`` (``common/data_utils.py:29-45``):
    world→camera via quaternion rotation, *no* root-centering here (the
    generator root-centers), and the 4-dim normalized (f, c) conditioning
    vector per camera id.
    """
    for subject in dataset.subjects():
        for action in dataset[subject].keys():
            anim = dataset[subject][action]
            positions_3d, camera_para = [], []
            for cam in anim["cameras"]:
                pos_3d = world_to_camera(
                    anim["positions"], rotation=cam["orientation"], translation=cam["translation"]
                )
                positions_3d.append(pos_3d.astype(np.float32))
                camera_para.append(camera_para_for_id(cam["id"]))
            anim["positions_3d"] = positions_3d
            anim["camera_para"] = camera_para
    return dataset


def create_2d_data(path: str, dataset: Human36mDataset) -> dict:
    """Load the 2D GMM keypoints npz, truncate to mocap length, normalize uv.

    Matches ``create_2d_data`` (``common/data_utils.py:65-87``): kernel
    mean channels 1:3 are screen-normalized with each camera's resolution.
    """
    keypoints = np.load(path, allow_pickle=True)["positions_2d"].item()

    for subject in dataset.subjects():
        for action in dataset[subject].keys():
            for cam_idx in range(len(keypoints[subject][action])):
                mocap_len = dataset[subject][action]["positions_3d"][cam_idx].shape[0]
                assert keypoints[subject][action][cam_idx].shape[0] >= mocap_len
                keypoints[subject][action][cam_idx] = keypoints[subject][action][cam_idx][:mocap_len]

    for subject in keypoints.keys():
        for action in keypoints[subject]:
            for cam_idx, kps in enumerate(keypoints[subject][action]):
                cam = dataset.cameras()[subject][cam_idx]
                kps[..., 1:3] = normalize_screen_coordinates(
                    kps[..., 1:3], w=cam["res_w"], h=cam["res_h"]
                )
                keypoints[subject][action][cam_idx] = kps
    return keypoints


def fetch(
    subjects: Sequence[str],
    dataset: Human36mDataset,
    keypoints: dict,
    action_filter: Optional[Sequence[str]] = None,
    stride: int = 1,
) -> Tuple[List[np.ndarray], List[np.ndarray], List[List[str]], List[np.ndarray]]:
    """Flatten subjects×actions×cameras into parallel per-sequence lists.

    Returns ``(poses_3d, poses_2d_gmm, actions, camera_para)`` where
    ``camera_para[i]`` is the per-frame [F, 4] conditioning array.
    Equivalent to ``fetch_me`` (``common/data_utils.py:131-174``) minus its
    stride-branch bug (``:172`` assigns 3D poses into the camera slot; we
    stride all four lists consistently).
    """
    out_3d, out_2d, out_actions, out_campara = [], [], [], []
    for subject in subjects:
        for action in keypoints[subject].keys():
            if action_filter is not None:
                if action.split(" ")[0] not in set(action_filter):
                    continue
            poses_2d = keypoints[subject][action]
            poses_3d = dataset[subject][action]["positions_3d"]
            camera_para = dataset[subject][action]["camera_para"]
            assert len(poses_3d) == len(poses_2d), "Camera count mismatch"
            for i in range(len(poses_2d)):
                out_2d.append(poses_2d[i])
                out_actions.append([action.split(" ")[0]] * poses_2d[i].shape[0])
                out_3d.append(poses_3d[i])
                out_campara.append(
                    np.tile(camera_para[i][None], (poses_3d[i].shape[0], 1))
                )

    if stride > 1:
        for i in range(len(out_2d)):
            out_2d[i] = out_2d[i][::stride]
            out_actions[i] = out_actions[i][::stride]
            out_3d[i] = out_3d[i][::stride]
            out_campara[i] = out_campara[i][::stride]

    return out_3d, out_2d, out_actions, out_campara


@dataclass
class FlatDataset:
    """Contiguous frame-major arrays — the device-friendly dataset form.

    ``poses_3d`` are root-centered (the generator's convention,
    ``common/generators.py:19``); ``action_ids`` index into ``actions``.
    """

    poses_3d: np.ndarray        # [F, 17, 3] float32, root-centered
    poses_2d_gmm: np.ndarray    # [F, 17, K, 5] float32
    action_ids: np.ndarray      # [F] int32
    camera_para: np.ndarray     # [F, 4] float32
    actions: Tuple[str, ...]    # id → action name

    def __len__(self):
        return self.poses_3d.shape[0]

    def action_names(self) -> List[str]:
        return [self.actions[i] for i in self.action_ids]


def flatten_sequences(
    poses_3d: List[np.ndarray],
    poses_2d_gmm: List[np.ndarray],
    actions: List[List[str]],
    camera_para: List[np.ndarray],
) -> FlatDataset:
    """Concatenate ragged sequences and root-center the 3D poses."""
    p3 = np.concatenate(poses_3d).astype(np.float32)
    p3 = p3 - p3[:, :1, :]
    p2 = np.concatenate(poses_2d_gmm).astype(np.float32)
    flat_actions: List[str] = []
    for a in actions:
        flat_actions.extend(a)
    vocab = tuple(sorted(set(flat_actions)))
    index = {a: i for i, a in enumerate(vocab)}
    ids = np.asarray([index[a] for a in flat_actions], np.int32)
    cp = np.concatenate(camera_para).astype(np.float32)
    assert p3.shape[0] == p2.shape[0] == ids.shape[0] == cp.shape[0]
    return FlatDataset(p3, p2, ids, cp, vocab)


def prepare_h36m_sequences(
    path_3d: str,
    path_2d_train: str,
    path_2d_test: str,
    action_filter: Optional[Sequence[str]] = None,
    stride: int = 1,
):
    """Sequence-level (unflattened) preparation for the video family.

    Returns ``(train, test)`` where each is ``(poses_3d, poses_2d_gmm,
    actions)`` per-sequence lists suitable for cutting video windows
    (windows must not cross sequence boundaries, so flattening would lose
    required structure).
    """
    from diffpose_tpu_torch.data.h36m import TRAIN_SUBJECTS, TEST_SUBJECTS

    dataset = Human36mDataset(path_3d)
    read_3d_data(dataset)
    kp_train = create_2d_data(path_2d_train, dataset)
    kp_test = create_2d_data(path_2d_test, dataset)
    tr3, tr2, tra, _ = fetch(TRAIN_SUBJECTS, dataset, kp_train, action_filter, stride)
    te3, te2, tea, _ = fetch(TEST_SUBJECTS, dataset, kp_test, action_filter, stride)
    return (tr3, tr2, tra), (te3, te2, tea)


def prepare_h36m(
    path_3d: str,
    path_2d_train: str,
    path_2d_test: str,
    action_filter: Optional[Sequence[str]] = None,
    stride: int = 1,
) -> Tuple[FlatDataset, FlatDataset]:
    """One-call dataset preparation → (train, test) flat datasets."""
    from diffpose_tpu_torch.data.h36m import TRAIN_SUBJECTS, TEST_SUBJECTS

    dataset = Human36mDataset(path_3d)
    read_3d_data(dataset)
    kp_train = create_2d_data(path_2d_train, dataset)
    kp_test = create_2d_data(path_2d_test, dataset)
    train = flatten_sequences(*fetch(TRAIN_SUBJECTS, dataset, kp_train, action_filter, stride))
    test = flatten_sequences(*fetch(TEST_SUBJECTS, dataset, kp_test, action_filter, stride))
    return train, test
