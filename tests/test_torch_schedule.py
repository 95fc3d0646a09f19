"""Port β schedules and ᾱ vs diffpose_tpu.diffusion.schedule."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from diffpose_tpu.diffusion import schedule as js
from diffpose_tpu_torch.diffusion import schedule as ts

SCHEDULES = ("quad", "linear", "const", "jsd", "sigmoid", "cosine")


@pytest.mark.parametrize("kind", SCHEDULES)
def test_beta_schedules_exact(kind):
    kw = dict(beta_start=1e-4, beta_end=2e-2, num_diffusion_timesteps=51)
    want, got = js.get_beta_schedule(kind, **kw), ts.get_beta_schedule(kind, **kw)
    assert got.dtype == want.dtype and np.array_equal(got, want)


@pytest.mark.parametrize("kind", ("linear", "cosine"))
def test_alphas_and_compute_alpha(kind):
    """The port rounds the float64 product once (exact equality with numpy),
    while XLA multiplies float32 factors in a tree order: each of the 51
    roundings may add half an ulp, hence rtol 1e-6 (about 8 ulp) against JAX."""
    betas = js.get_beta_schedule(kind, beta_start=1e-4, beta_end=2e-2, num_diffusion_timesteps=51)
    got = ts.alphas_cumprod(betas)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(js.alphas_cumprod(betas)), rtol=1e-6)
    np.testing.assert_array_equal(got.numpy(), np.cumprod(1.0 - betas).astype(np.float32))
    t = np.array([-1, 0, 7, 50])
    got = ts.compute_alpha(betas, torch.as_tensor(t)).numpy()
    want = np.asarray(js.compute_alpha(betas, jnp.asarray(t)))
    assert got.shape == want.shape == (4, 1, 1)
    np.testing.assert_allclose(got, want, rtol=1e-6)
    assert got[0, 0, 0] == 1.0
