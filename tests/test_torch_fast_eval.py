"""The BigW inference form (``diffpose_tpu_torch/ops/fast_eval.py``) against
the port's ``GCNDiff`` / ``GCNPose`` in eval mode and against the JAX
package's ``diffpose_tpu/ops/fast_eval.py`` on the same weights (a Flax init
carried across by ``models/convert.py``), as ``tests/test_fast_eval.py`` holds
the JAX one: f32 within 3e-5 (that file's bound), bf16 within its 0.15 / 0.1."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from diffpose_tpu.ops import make_fast_denoiser as jax_fast_denoiser
from diffpose_tpu.ops import make_fast_lifter as jax_fast_lifter
from diffpose_tpu_torch.ops import make_fast_denoiser, make_fast_lifter, precompute_fast_params
from test_torch_models import BASIS, flax_pair

TOL = 3e-5          # tests/test_fast_eval.py
SMALL = dict(hid_dim=32, num_layers=2, num_heads=4)
NET = dict(hid_dim=96, num_layers=2, num_heads=4)   # the production widths, fewer layers


def test_fast_denoiser_matches_module_forward_and_the_jax_function(rng):
    _, params, tm = flax_pair(NET, 0, with_temb=True)
    x = rng.normal(size=(8, 17, 5)).astype(np.float32)
    t = np.array([0, 6, 12, 24, 30, 40, 50, 3], np.float32)
    got = make_fast_denoiser(tm, device="cpu")(torch.as_tensor(x), torch.as_tensor(t))
    with torch.no_grad():
        want = tm(torch.as_tensor(x), torch.as_tensor(t))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL)
    jax_got = jax.jit(jax_fast_denoiser(params, BASIS, **NET))(jnp.asarray(x), jnp.asarray(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_got), atol=TOL)


def test_fast_denoiser_small_config(rng):
    _, params, tm = flax_pair(SMALL, 1, with_temb=True)
    x = rng.normal(size=(4, 17, 5)).astype(np.float32)
    t = np.zeros(4, np.float32)
    got = make_fast_denoiser(tm, device="cpu")(torch.as_tensor(x), torch.as_tensor(t))
    with torch.no_grad():
        want = tm(torch.as_tensor(x), torch.as_tensor(t))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL)
    fp = precompute_fast_params(tm, device="cpu")
    assert fp["gconv_input"]["w"].shape == (17 * 5, 17 * 32)       # BigW [N·C, N·D]
    assert len(fp["layers"]) == 2 and fp["layers"][0]["wqkv"].shape == (32, 96)


def test_fast_lifter_matches_module_forward_and_the_jax_function(rng):
    _, params, tm = flax_pair(NET, 3, with_temb=False)
    x = rng.normal(size=(6, 17, 2)).astype(np.float32)
    got = make_fast_lifter(tm, device="cpu")(torch.as_tensor(x))
    with torch.no_grad():
        want = tm(torch.as_tensor(x))
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=TOL)
    jax_got = jax.jit(jax_fast_lifter(params, BASIS, **NET))(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_got), atol=TOL)


def test_fast_denoiser_bf16_close(rng):
    _, params, tm = flax_pair(SMALL, 2, with_temb=True)
    x = rng.normal(size=(4, 17, 5)).astype(np.float32)
    t = np.zeros(4, np.float32)
    got = make_fast_denoiser(tm, dtype=torch.bfloat16, device="cpu")(torch.as_tensor(x),
                                                                      torch.as_tensor(t))
    assert got.dtype == torch.float32
    with torch.no_grad():
        want = tm(torch.as_tensor(x), torch.as_tensor(t)).numpy()
    # bf16 keeps about 3 decimal digits; the 2-layer residual net stays close
    np.testing.assert_allclose(got.numpy(), want, atol=0.15, rtol=0.1)
    jax_got = jax.jit(jax_fast_denoiser(params, BASIS, dtype=jnp.bfloat16, **SMALL))(
        jnp.asarray(x), jnp.asarray(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_got), atol=0.15, rtol=0.1)
