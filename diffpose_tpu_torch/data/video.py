"""Temporal-window datasets for the video family.

Counterpart of ``diffpose_tpu/data/video.py``, array for array: ``[W, F, …]``
windows cut from per-sequence lists (the output of
:func:`diffpose_tpu_torch.data.pipeline.prepare_h36m_sequences`), never
across a sequence boundary; non-overlapping by default (``stride=frames``).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np


@dataclass
class VideoDataset:
    poses_3d: np.ndarray       # [W, F, J, 3] root-centred per frame
    poses_2d_gmm: np.ndarray   # [W, F, J, K, 5]
    action_ids: np.ndarray     # [W], the action of each window's first frame
    actions: Tuple[str, ...]

    def __len__(self):
        return self.poses_3d.shape[0]


def make_video_windows(
    poses_3d: List[np.ndarray],
    poses_2d_gmm: List[np.ndarray],
    actions: List[List[str]],
    frames: int,
    stride: Optional[int] = None,
) -> VideoDataset:
    stride = stride or frames
    w3, w2, wa = [], [], []
    for p3, p2, act in zip(poses_3d, poses_2d_gmm, actions):
        assert p3.shape[0] == p2.shape[0] == len(act)
        for start in range(0, p3.shape[0] - frames + 1, stride):
            w3.append(p3[start:start + frames])
            w2.append(p2[start:start + frames])
            wa.append(act[start])
    if not w3:
        raise ValueError(f"no sequence long enough for {frames}-frame windows")
    p3 = np.stack(w3).astype(np.float32)
    p3 = p3 - p3[:, :, :1, :]  # root-centre every frame
    vocab = tuple(sorted(set(wa)))
    index = {a: i for i, a in enumerate(vocab)}
    ids = np.asarray([index[a] for a in wa], np.int32)
    return VideoDataset(p3, np.stack(w2).astype(np.float32), ids, vocab)


def synthetic_video_dataset(num_windows: int = 8, frames: int = 16, n_kernels: int = 3,
                            seed: int = 0) -> VideoDataset:
    """Synthetic windows in the video format (tests, smoke runs): one
    synthetic sequence of ``num_windows · frames`` frames, cut in windows."""
    from diffpose_tpu_torch.data.synthetic import make_synthetic_dataset

    flat = make_synthetic_dataset(num_windows * frames, n_kernels, seed)
    return make_video_windows([flat.poses_3d], [flat.poses_2d_gmm],
                              [[flat.actions[i] for i in flat.action_ids]], frames)
