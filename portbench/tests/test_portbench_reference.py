"""The plain reference against the program's module path at a tiny size on the
CPU: the networks, the frame eval step, and P-MPJPE."""

import numpy as np
import pytest
import torch

from portbench.harness import counts, data, weights
from portbench.reference import nets, protocol
from portbench.reference import frame as ref_frame

BASIS = counts.cheb_basis()
B64 = torch.as_tensor(BASIS, dtype=torch.float64)


def close(got, want, rel):
    """Largest gap within ``rel`` of the largest magnitude of ``want``."""
    got, want = torch.as_tensor(got).double(), torch.as_tensor(want).double()
    return float((got - want).abs().max()) <= rel * float(want.abs().max())


def _module(cls, seed, **kw):
    m = cls(BASIS.astype(np.float32), **kw)
    w = weights.make(weights.shapes_of(m), seed, "cpu")
    m.load_state_dict(w)
    return m.double().eval(), {k: v.double() for k, v in w.items()}


def test_frame_networks():
    from diffpose_tpu_torch.models import GCNDiff, GCNPose

    den, p = _module(GCNDiff, 1, hid_dim=16, num_layers=2, num_heads=4)
    gen = torch.Generator().manual_seed(0)
    x, t = torch.randn(3, 17, 5, generator=gen), torch.tensor([0.0, 5.0, 12.0])
    want = den.float()(x, t)     # its timestep embedding is float32 whatever the input
    assert close(nets.gcn_diff(p, x.double(), t.double(), B64, hid=16, layers=2, heads=4), want, 1e-5)
    lift, q = _module(GCNPose, 2, hid_dim=16, num_layers=2, num_heads=4)
    x2 = torch.randn(3, 17, 2, dtype=torch.float64, generator=gen)
    assert close(nets.gcn_pose(q, x2, B64, layers=2, heads=4), lift(x2), 1e-6)


def _frame_eval_cfg(test_times):
    return dict(hid=96, layers=5, heads=4, test_times=test_times, seq=[0, 12],
                betas=protocol.linear_betas(1e-4, 1e-3, 51), loader_seed=77, basis=BASIS)


@pytest.mark.parametrize("test_times", [1, 2])
def test_frame_eval_step(test_times):
    from diffpose_tpu_torch.diffusion import get_beta_schedule
    from diffpose_tpu_torch.models import GCNDiff, GCNPose
    from diffpose_tpu_torch.train.state import TrainState
    from diffpose_tpu_torch.train.steps import make_eval_step

    den, p = _module(GCNDiff, 5)
    lift, q = _module(GCNPose, 6, coords_in=2, coords_out=3)
    den.float(), lift.float()
    d = data.frames(8, 9)
    rows = np.arange(8)
    betas = get_beta_schedule("linear", beta_start=1e-4, beta_end=1e-3, num_diffusion_timesteps=51)
    step = make_eval_step(den, lift, betas, [0, 12], test_times=test_times, impl="module", device="cpu")
    batch = {"poses_3d": d["poses_3d"], "poses_2d_gmm": d["poses_2d_gmm"],
             "seeds": protocol.sample_ids(rows, seed=77)}
    p1, p2, pred = step(TrainState.create(den, None, None), lift, batch)
    ref = ref_frame.eval_batch(p, q, d, rows, _frame_eval_cfg(test_times), "cpu")
    assert np.max(np.abs(pred.numpy() - ref["pred"])) <= 1e-5 * np.max(np.abs(ref["pred"]))
    assert np.allclose(p1.numpy(), ref["p1"], rtol=1e-5, atol=1e-6)
    assert np.allclose(p2.numpy(), ref["p2"], rtol=1e-4, atol=1e-5)


def test_p_mpjpe_matches_program():
    from diffpose_tpu_torch.metrics import p_mpjpe_per_sample

    d = data.frames(64, 3)
    target = d["poses_3d"].astype(np.float64)
    pred = target + 0.05 * np.random.default_rng(0).normal(size=target.shape)
    want = p_mpjpe_per_sample(torch.as_tensor(pred), torch.as_tensor(target), method="svd").numpy()
    assert np.allclose(protocol.p_mpjpe(pred, target), want, rtol=1e-6, atol=1e-9)
