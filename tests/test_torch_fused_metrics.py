"""The per-sample P-MPJPE's kernel wrapper (``ops/fused_metrics.py``) on the
CPU: its plain version is ``metrics.py``'s quaternion Procrustes bit for bit,
``p_mpjpe_per_sample`` sends only 3-D poses by the quaternion method to it,
and its input checks raise before any library is loaded.  The kernel itself
runs only on the card (``chip_smoke.py``'s metric phase)."""

import numpy as np
import pytest
import torch

from diffpose_tpu_torch import metrics as tm
from diffpose_tpu_torch.ops import fused_metrics as fm

torch.set_num_threads(1)


def case_poses(rng, case: str, n: int = 6, j: int = 17):
    """``pred``, ``target`` [n, j, 3] float32 for one case."""
    target = rng.normal(scale=0.25, size=(n, j, 3))
    if case == "random":
        pred = target + 0.05 * rng.normal(size=target.shape)
    elif case == "reflected":                  # det H < 0: the reflection fix
        pred = target * np.array([-1.0, 1.0, 1.0]) + 0.01 * rng.normal(size=target.shape)
    elif case == "identical":
        pred = target.copy()
    else:                                      # planar, near-collinear: a near-tie of λ_max
        d, e = np.linalg.qr(rng.normal(size=(n, 3, 2)))[0].transpose(2, 0, 1)[:, :, None]
        s = np.linspace(-0.5, 0.5, j)[None, :, None]
        target = s * d + 1e-3 * rng.normal(size=(n, j, 1)) * e
        pred = target[..., [1, 0, 2]] * np.array([1.0, -1.0, 1.0])   # a quarter turn about z
        pred = pred + 1e-3 * rng.normal(size=target.shape)
    return torch.as_tensor(pred, dtype=torch.float32), torch.as_tensor(target, dtype=torch.float32)


@pytest.mark.parametrize("case", ["random", "reflected", "identical", "planar_near_collinear"])
def test_wrapper_on_cpu_is_the_quaternion_path(rng, case):
    pred, target = case_poses(rng, case)
    want = torch.linalg.vector_norm(tm.procrustes_align(pred, target, method="quat") - target,
                                    dim=-1).mean(dim=-1)
    for got in (fm.fused_p_mpjpe(pred, target), tm.p_mpjpe_per_sample(pred, target)):
        torch.testing.assert_close(got, want, rtol=0, atol=0, equal_nan=True)
    assert fm.fused_p_mpjpe.launches == 0


@pytest.mark.parametrize("coords, method, fused", [(3, "quat", True), (3, "svd", False),
                                                   (2, "quat", False), (2, "svd", False)])
def test_dispatch_only_3d_quaternion_to_the_wrapper(rng, monkeypatch, coords, method, fused):
    calls = []
    monkeypatch.setattr(tm, "fused_p_mpjpe", lambda p, t: calls.append(p) or fm.fused_p_mpjpe(p, t))
    pred, target = (x[..., :coords] for x in case_poses(rng, "random"))
    got = tm.p_mpjpe_per_sample(pred, target, method=method)
    assert len(calls) == int(fused)
    torch.testing.assert_close(got, tm.p_mpjpe_plain(pred, target, method=method), rtol=0, atol=0)


@pytest.mark.parametrize("what", ["coords_2", "shapes_differ", "float64", "no_joints", "grad"])
def test_kernel_input_checks_raise_before_loading(monkeypatch, what):
    monkeypatch.setattr(fm, "_library", lambda: pytest.fail("the library was loaded"))
    pred, target = torch.zeros(4, 17, 3), torch.zeros(4, 17, 3)
    if what == "coords_2":
        pred, target = pred[..., :2], target[..., :2]
    elif what == "shapes_differ":
        target = torch.zeros(4, 16, 3)
    elif what == "float64":
        pred = pred.double()
    elif what == "no_joints":
        pred, target = torch.zeros(4, 0, 3), torch.zeros(4, 0, 3)
    else:
        pred.requires_grad_(True)
    with pytest.raises(ValueError):
        fm._launch(pred, target)


def test_eval_step_calls_the_metrics_by_their_module_names():
    """The benchmark's planted faults patch these two names of the eval step's module."""
    from diffpose_tpu_torch.train import steps

    assert steps.mpjpe_per_sample is tm.mpjpe_per_sample
    assert steps.p_mpjpe_per_sample is tm.p_mpjpe_per_sample
