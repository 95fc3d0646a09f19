"""Port synthetic dataset vs the JAX package's: the same numpy stream, equal arrays."""

import numpy as np
import pytest

from diffpose_tpu.data import synthetic as jsyn
from diffpose_tpu.data.h36m import ALL_ACTIONS
from diffpose_tpu_torch.data import synthetic as syn
from diffpose_tpu_torch.graph import H36M_EDGES


@pytest.mark.parametrize("kwargs", [
    dict(num_frames=96, seed=0),
    dict(num_frames=33, seed=5, n_kernels=3, noise_2d=0.02),
    dict(num_frames=64, seed=1, pose_modes=4),
], ids=["default", "kernels3", "modes4"])
def test_arrays_equal_the_jax_package(kwargs):
    want, got = jsyn.make_synthetic_dataset(**kwargs), syn.make_synthetic_dataset(**kwargs)
    for name in ("poses_3d", "poses_2d_gmm", "action_ids", "camera_para"):
        a, b = getattr(got, name), getattr(want, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.actions == want.actions == ALL_ACTIONS == syn.ALL_ACTIONS
    assert len(got) == kwargs["num_frames"]


def test_skeleton_is_consistent():
    ds = syn.make_synthetic_dataset(num_frames=16, seed=2)
    assert ds.poses_3d.shape == (16, 17, 3) and ds.poses_2d_gmm.shape == (16, 17, 5, 5)
    np.testing.assert_array_equal(ds.poses_3d[:, 0], 0)  # root-centred
    for e, (p, c) in enumerate(H36M_EDGES):
        np.testing.assert_allclose(np.linalg.norm(ds.poses_3d[:, c] - ds.poses_3d[:, p], axis=-1),
                                   syn._BONE_LENGTHS[e], rtol=1e-5)
    np.testing.assert_allclose(ds.poses_2d_gmm[..., 0].sum(-1), 1.0, atol=1e-5)
    assert (ds.poses_2d_gmm[..., 3:] > 0).all()


def test_bone_lengths_copy_matches():
    assert syn._BONE_LENGTHS == jsyn._BONE_LENGTHS
