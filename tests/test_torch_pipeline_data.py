"""Port data pipeline (skeleton, geometry, cameras, H3.6M dataset, flattening)
vs diffpose_tpu.data on a fabricated mini-H36M npz pair."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from diffpose_tpu import geometry as jgeo
from diffpose_tpu.data import h36m as jh36m
from diffpose_tpu.data import pipeline as jpipe
from diffpose_tpu.data.synthetic import make_synthetic_dataset as j_make_synthetic_dataset
from diffpose_tpu_torch import geometry as geo
from diffpose_tpu_torch.data import h36m, h36m_cameras, pipeline
from diffpose_tpu_torch.data import synthetic

# Small tensors on a host that runs several test workers: one thread each is
# faster than contended thread pools.
torch.set_num_threads(1)


def fabricate(tmp_path, rng):
    """The npz pair of tests/test_data.py (32 raw joints, 4 cameras, 2D tracks
    two frames longer than the mocap), with every train and test subject."""
    subjects = {"S1": ["Walking 1", "Eating"], "S9": ["Walking 1"], "S5": ["Eating 2"],
                "S6": ["Photo"], "S7": ["Walking"], "S8": ["Sitting 1"], "S11": ["Eating", "Photo 1"]}
    pos_3d = {s: {a: rng.normal(scale=0.3, size=(9, 32, 3)).astype(np.float32) for a in acts}
              for s, acts in subjects.items()}
    np.savez(tmp_path / "data_3d.npz", positions_3d=np.array(pos_3d, dtype=object))
    kp = {}
    for s, acts in subjects.items():
        kp[s] = {}
        for a in acts:
            kp[s][a] = [rng.uniform(0, 1000, size=(11, 17, 5, 5)).astype(np.float32)
                        for _ in range(4)]
            for arr in kp[s][a]:
                arr[..., 0] = 1.0 / 5
    np.savez(tmp_path / "data_2d.npz", positions_2d=np.array(kp, dtype=object))
    return str(tmp_path / "data_3d.npz"), str(tmp_path / "data_2d.npz")


def assert_flat_equal(a, b):
    for field in ("poses_3d", "poses_2d_gmm", "action_ids", "camera_para"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and x.shape == y.shape, field
        np.testing.assert_array_equal(x, y, err_msg=field)
    assert a.actions == b.actions and len(a) == len(b)


@pytest.mark.parametrize("kwargs", [{}, {"stride": 2}, {"action_filter": ["Walking"]}],
                         ids=["all", "stride2", "walking"])
def test_prepare_h36m_equals_jax(tmp_path, rng, kwargs):
    p3, p2 = fabricate(tmp_path, rng)
    train, test = pipeline.prepare_h36m(p3, p2, p2, **kwargs)
    jtrain, jtest = jpipe.prepare_h36m(p3, p2, p2, **kwargs)
    assert_flat_equal(train, jtrain)
    assert_flat_equal(test, jtest)
    assert len(train) > 0 and len(test) > 0
    assert train.action_names() == jtrain.action_names()


def test_prepare_h36m_sequences_equals_jax(tmp_path, rng):
    p3, p2 = fabricate(tmp_path, rng)
    ours = pipeline.prepare_h36m_sequences(p3, p2, p2)
    theirs = jpipe.prepare_h36m_sequences(p3, p2, p2)
    for split, jsplit in zip(ours, theirs):
        for seqs, jseqs in zip(split[:2], jsplit[:2]):
            assert len(seqs) == len(jseqs)
            for a, b in zip(seqs, jseqs):
                np.testing.assert_array_equal(a, b)
        assert split[2] == jsplit[2]


def test_dataset_skeleton_and_cameras_equal_jax(tmp_path, rng):
    p3, _ = fabricate(tmp_path, rng)
    ours, theirs = h36m.Human36mDataset(p3), jh36m.Human36mDataset(p3)
    sk, jsk = ours.skeleton(), theirs.skeleton()
    assert sk.num_joints() == jsk.num_joints() == 17
    np.testing.assert_array_equal(sk.parents(), jsk.parents())
    assert sk.joints_left() == jsk.joints_left() and sk.joints_right() == jsk.joints_right()
    assert ours.subjects() == theirs.subjects()
    for s in ours.subjects():
        for cam, jcam in zip(ours.cameras()[s], theirs.cameras()[s]):
            assert set(cam) == set(jcam)
            for k in cam:
                np.testing.assert_array_equal(np.asarray(cam[k]), np.asarray(jcam[k]), err_msg=k)
    for cam_id in list(h36m_cameras.CAMERA_PARA)[:4]:
        np.testing.assert_array_equal(h36m.camera_para_for_id(cam_id),
                                      jh36m.camera_para_for_id(cam_id))
    assert h36m.ALL_ACTIONS == jh36m.ALL_ACTIONS
    assert (h36m.TRAIN_SUBJECTS, h36m.TEST_SUBJECTS) == (jh36m.TRAIN_SUBJECTS, jh36m.TEST_SUBJECTS)


def test_geometry_equals_jax(rng):
    x = rng.normal(size=(5, 17, 3)).astype(np.float32)
    q = rng.normal(size=(4,)).astype(np.float32)
    q /= np.linalg.norm(q)
    t = rng.normal(size=(3,)).astype(np.float32)
    np.testing.assert_array_equal(geo.world_to_camera(x, q, t), jgeo.world_to_camera(x, q, t))
    np.testing.assert_array_equal(geo.camera_to_world(x, q, t), jgeo.camera_to_world(x, q, t))
    np.testing.assert_array_equal(geo.qinverse(q), jgeo.qinverse(q))
    uv = rng.uniform(0, 1000, size=(5, 17, 2))
    np.testing.assert_array_equal(geo.normalize_screen_coordinates(uv, 1000, 1002),
                                  jgeo.normalize_screen_coordinates(uv, 1000, 1002))
    np.testing.assert_array_equal(geo.image_coordinates(uv, 1000, 1002),
                                  jgeo.image_coordinates(uv, 1000, 1002))
    cam_x = x + np.array([0.0, 0.0, 5.0], np.float32)
    intr = rng.uniform(0.1, 1.0, size=(5, 9)).astype(np.float32)
    for name in ("project_to_2d", "project_to_2d_linear"):
        got = getattr(geo, name)(torch.as_tensor(cam_x), torch.as_tensor(intr)).numpy()
        want = np.asarray(getattr(jgeo, name)(jnp.asarray(cam_x), jnp.asarray(intr)))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6, err_msg=name)


def test_flat_dataset_lives_in_pipeline_and_synthetic_reexports_it():
    assert synthetic.FlatDataset is pipeline.FlatDataset
    ours = synthetic.make_synthetic_dataset(num_frames=40, seed=2, pose_modes=3)
    assert isinstance(ours, pipeline.FlatDataset)
    assert_flat_equal(ours, j_make_synthetic_dataset(num_frames=40, seed=2, pose_modes=3))
