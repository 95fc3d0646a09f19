"""Port metrics (MPJPE family, Procrustes by quaternion and by SVD, the
per-action accounting) vs diffpose_tpu.metrics on numpy-seeded inputs."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from diffpose_tpu import metrics as jm
from diffpose_tpu_torch import metrics as tm

# Small tensors on a host that runs several test workers: one thread each is
# faster than contended thread pools.
torch.set_num_threads(1)

RTOL = 1e-5


def poses(rng, *shape):
    pred = rng.normal(size=shape).astype(np.float32)
    return pred, (pred + 0.3 * rng.normal(size=shape)).astype(np.float32)


def both(name, *arrays, **kwargs):
    want = np.asarray(getattr(jm, name)(*(jnp.asarray(a) for a in arrays), **kwargs))
    got = getattr(tm, name)(*(torch.as_tensor(a) for a in arrays), **kwargs)
    return np.asarray(got), want


@pytest.mark.parametrize("name", ["mpjpe", "mpjpe_per_sample", "n_mpjpe", "p_mpjpe",
                                  "p_mpjpe_per_sample", "root_center"])
def test_metric_matches_jax(rng, name):
    pred, tgt = poses(rng, 12, 17, 3)
    args = (pred,) if name == "root_center" else (pred, tgt)
    got, want = both(name, *args)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)


def test_weighted_mpjpe_and_velocity_error(rng):
    pred, tgt = poses(rng, 9, 17, 3)
    w = rng.uniform(0.5, 2.0, size=(17,)).astype(np.float32)
    got, want = both("weighted_mpjpe", pred, tgt, w)
    np.testing.assert_allclose(got, want, rtol=RTOL)
    assert tm.mean_velocity_error(torch.as_tensor(pred), tgt) == pytest.approx(
        jm.mean_velocity_error(pred, tgt), rel=1e-6)


@pytest.mark.parametrize("method", ["quat", "svd"])
def test_procrustes_align_matches_jax(rng, method):
    pred, tgt = poses(rng, 16, 17, 3)
    tgt[:3, :, 0] *= -1                     # mirrored targets: the reflection fix
    got, want = both("procrustes_align", pred, tgt, method=method)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=2e-5)
    err_t = np.linalg.norm(got - tgt, axis=-1).mean(-1)
    err_j = np.linalg.norm(want - tgt, axis=-1).mean(-1)
    np.testing.assert_allclose(err_t, err_j, rtol=1e-4)     # tests/test_metrics.py's grade
    got2, want2 = both("procrustes_align", pred[..., :2], tgt[..., :2], method=method)
    np.testing.assert_allclose(got2, want2, rtol=1e-4, atol=2e-5)


def test_quat_equals_svd_and_recovers_a_similarity(rng):
    from scipy.spatial.transform import Rotation

    pred = rng.normal(size=(4, 17, 3)).astype(np.float32)
    r = Rotation.random(random_state=0).as_matrix().astype(np.float32)
    tgt = (1.7 * pred @ r.T + rng.normal(size=(4, 1, 3))).astype(np.float32)
    for method in ("quat", "svd"):
        err = tm.p_mpjpe_per_sample(torch.as_tensor(pred), torch.as_tensor(tgt), method=method)
        assert float(err.max()) < 1e-4
    pred2, tgt2 = poses(rng, 32, 17, 3)
    a = tm.p_mpjpe_per_sample(torch.as_tensor(pred2), torch.as_tensor(tgt2), method="quat")
    b = tm.p_mpjpe_per_sample(torch.as_tensor(pred2), torch.as_tensor(tgt2), method="svd")
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4)


def fold(mod, rng_seed, reference_compat, as_tensor):
    rng = np.random.default_rng(rng_seed)
    actions = list(mod.H36M_ACTIONS)
    acc = mod.ActionErrorAccumulator(actions, reference_compat=reference_compat)
    for mixed in (True, False, True):
        n = 24
        ids = rng.integers(0, 15, size=n) if mixed else np.full(n, 4)
        valid = np.arange(n) < n - 5
        p1 = rng.uniform(0.02, 0.2, size=n).astype(np.float32)
        p2 = rng.uniform(0.01, 0.1, size=n).astype(np.float32)
        conv = as_tensor or (lambda v: v)
        acc.add({"valid": valid, "action_ids": ids.astype(np.int32)}, conv(p1), conv(p2))
    return acc


@pytest.mark.parametrize("reference_compat", [True, False], ids=["compat", "per_sample"])
def test_action_table_is_string_equal(capsys, reference_compat):
    want_acc = fold(jm, 3, reference_compat, None)
    got_acc = fold(tm, 3, reference_compat, torch.as_tensor)
    want = want_acc.summarize(print_table=True)
    want_out = capsys.readouterr().out
    got = got_acc.summarize(print_table=True)
    got_out = capsys.readouterr().out
    assert got_out == want_out and got_out.count("\n") == 17
    assert got == want and got_acc.frames == want_acc.frames == 57
    assert got_acc.p1_meter.avg == want_acc.p1_meter.avg
    assert got_acc.p2_meter.avg == want_acc.p2_meter.avg


def test_meters_and_error_list():
    for name in ("AccumLoss", "AverageMeter"):
        a, b = getattr(tm, name)(), getattr(jm, name)()
        for v, n in ((1.5, 2), (0.25, 3)):
            a.update(v, n)
            b.update(v, n)
        assert (a.val, a.sum, a.count, a.avg) == (b.val, b.sum, b.count, b.avg)
    errs = tm.define_error_list(["Walking", "Eating"])
    tm.accumulate_action_errors(errs, np.array([0.1, 0.2]), np.array([0.05, 0.07]),
                                ["Walking 1", "Eating"], reference_compat=False)
    assert errs["Walking"]["p2"].avg == pytest.approx(0.05)
    assert tm.summarize_action_errors(errs) == pytest.approx((150.0, 60.0))
