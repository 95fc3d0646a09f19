"""Port DDIM sampling and the forward process vs diffpose_tpu.diffusion.ddim."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffpose_tpu.diffusion import ddim as jd
from diffpose_tpu.diffusion import schedule as js
from diffpose_tpu_torch.diffusion import ddim as td

BETAS = js.get_beta_schedule("linear", beta_start=1e-4, beta_end=1e-3, num_diffusion_timesteps=51)


@pytest.mark.parametrize("args", [("uniform", 2, 25), ("uniform", 10, 1000),
                                  ("quad", 5, 51), ("quad", 20, 1000)])
def test_make_skip_sequence(args):
    assert td.make_skip_sequence(*args) == jd.make_skip_sequence(*args)


def test_q_sample(rng):
    x0 = rng.normal(size=(6, 17, 5)).astype(np.float32)
    noise = rng.normal(size=(6, 17, 5)).astype(np.float32)
    t = rng.integers(0, 51, size=6)
    want = jd.q_sample(jnp.asarray(x0), jnp.asarray(t), jnp.asarray(noise), BETAS)
    got = td.q_sample(torch.as_tensor(x0), torch.as_tensor(t), torch.as_tensor(noise), BETAS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def _stub(x, t, lib):
    """Analytic stand-in for the denoiser, identical in both frameworks."""
    return 0.1 * x * (1.0 + t[:, None, None] / 50.0) + 0.01 * lib.sin(x)


@pytest.mark.parametrize("seq", [(0, 12), (0, 10, 20, 30, 40, 50)])
def test_ddim_deterministic(rng, seq):
    x = rng.normal(size=(5, 17, 5)).astype(np.float32)
    want, want_x0 = jd.ddim_sample(lambda a, t: _stub(a, t, jnp), jnp.asarray(x), seq, BETAS,
                                   return_x0_preds=True)
    got, got_x0 = td.ddim_sample(lambda a, t: _stub(a, t, torch), torch.as_tensor(x), seq, BETAS,
                                 return_x0_preds=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)
    np.testing.assert_allclose(got_x0.numpy(), np.asarray(want_x0), atol=1e-6)


def test_ddim_eta_same_noise(rng):
    """η > 0 with the JAX sampler's own normal draws handed to the port."""
    seq, eta = (0, 10, 20, 30), 0.7
    x = rng.normal(size=(4, 17, 5)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jd.ddim_sample(lambda a, t: _stub(a, t, jnp), jnp.asarray(x), seq, BETAS,
                          eta=eta, key=key)
    draws = [torch.tensor(np.asarray(jax.random.normal(k, x.shape, jnp.float32)))
             for k in jax.random.split(key, len(seq))]
    got = td.ddim_sample(lambda a, t: _stub(a, t, torch), torch.as_tensor(x), seq, BETAS,
                         eta=eta, noise=draws)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_ddim_eta_generator(rng):
    seq = (0, 10, 20, 30)
    x = torch.as_tensor(rng.normal(size=(4, 17, 5)).astype(np.float32))
    run = lambda **kw: td.ddim_sample(lambda a, t: _stub(a, t, torch), x, seq, BETAS, **kw)
    a = run(eta=0.5, generator=torch.Generator().manual_seed(1))
    b = run(eta=0.5, generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    assert not torch.allclose(a, run())
    with pytest.raises(ValueError):
        run(eta=0.5)
