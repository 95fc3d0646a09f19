"""Port eval pipeline (make_eval_fn on the CPU) vs the JAX Pallas pipeline in
interpret mode and vs the JAX module pipeline."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from diffpose_tpu.diffusion import ddim_sample, get_beta_schedule
from diffpose_tpu.graph import BODY_EDGES, cheb_basis_from_edges
from diffpose_tpu.ops.pallas_pipeline import make_pallas_eval
from diffpose_tpu_torch.ops.fused_denoiser import prepare_weights
from diffpose_tpu_torch.ops.fused_pipeline import make_eval_fn
from test_torch_models import BASIS, CONFIGS, flax_pair

CFG = CONFIGS[0]
BETAS = get_beta_schedule("linear", beta_start=1e-4, beta_end=1e-3, num_diffusion_timesteps=51)
SEQ = (0, 12)


def _models():
    diff = flax_pair(CFG, 0, with_temb=True)
    pose = flax_pair(CFG, 1, with_temb=False)
    return diff, pose


def _port_eval(diff, pose, x2d, test_times):
    fn = make_eval_fn(BASIS, seq=SEQ, betas=BETAS, test_times=test_times, device="cpu")
    with torch.no_grad():
        return fn(prepare_weights(pose[2], device="cpu"), prepare_weights(diff[2], device="cpu"),
                  x2d).numpy()


def _xla_eval(diff, pose, x2d, test_times):
    """The JAX module pipeline of tests/test_pallas_pipeline.py."""
    (jd, pd, _), (jp, pp, _) = diff, pose
    mask = jnp.ones((1, 1, 17))
    xyz = jp.apply({"params": pp}, x2d, mask)
    xyz = xyz - xyz[:, :1, :]
    uvxyz = jnp.tile(jnp.concatenate([x2d, xyz], axis=-1), (test_times, 1, 1))
    out = ddim_sample(lambda x, t: jd.apply({"params": pd}, x, t, mask), uvxyz, SEQ, BETAS)
    return np.asarray(out.reshape(test_times, -1, 17, 5).mean(axis=0)[..., 2:])


@pytest.mark.parametrize("test_times,batch", [(1, 8), (2, 4)])
def test_eval_matches_pallas_interpret(rng, test_times, batch):
    diff, pose = _models()
    x2d = rng.normal(size=(batch, 17, 2)).astype(np.float32)
    want = make_pallas_eval(pose[1], diff[1], BASIS, seq=SEQ, betas=BETAS, test_times=test_times,
                            block_b=8, interpret=True, precision=None, **CFG)(jnp.asarray(x2d))
    got = _port_eval(diff, pose, x2d, test_times)
    assert got.shape == (batch, 17, 3)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("test_times", [1, 2, 5])
def test_eval_matches_xla_modules(rng, test_times):
    diff, pose = _models()
    x2d = rng.normal(size=(6, 17, 2)).astype(np.float32)
    want = _xla_eval(diff, pose, jnp.asarray(x2d), test_times)
    np.testing.assert_allclose(_port_eval(diff, pose, x2d, test_times), want, atol=2e-4)


def test_eval_rejects_weights_of_another_graph(rng):
    diff, pose = _models()
    other = cheb_basis_from_edges(17, BODY_EDGES + ((15, 16),))
    fn = make_eval_fn(other, seq=SEQ, betas=BETAS, device="cpu")
    with pytest.raises(ValueError, match="basis"):
        fn(prepare_weights(pose[2], device="cpu"), prepare_weights(diff[2], device="cpu"),
           rng.normal(size=(2, 17, 2)).astype(np.float32))
