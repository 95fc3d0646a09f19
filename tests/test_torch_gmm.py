"""Port GMM draw and antithetic timesteps vs the JAX package."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffpose_tpu.data import gmm as jgmm
from diffpose_tpu_torch.data import gmm
from diffpose_tpu_torch.diffusion import antithetic_timesteps


def _inputs(seed, b=12, j=17, k=5):
    rng = np.random.default_rng(seed)
    g = rng.normal(size=(b, j, k, 5)).astype(np.float32)
    g[..., 0] = rng.dirichlet(np.ones(k), size=(b, j))
    return g, rng.normal(size=(b, j, 3)).astype(np.float32)


def test_sample_gmm_batch_equals_jax_for_the_jax_choice():
    g, p3 = _inputs(0)
    key = jax.random.PRNGKey(3)
    logits = jnp.log(jnp.maximum(jnp.asarray(g)[..., 0], 1e-12))
    choice = np.array(jax.random.categorical(key, logits, axis=-1))
    want = jgmm.sample_gmm_batch(key, jnp.asarray(g), jnp.asarray(p3))
    got = gmm.sample_gmm_batch(None, torch.as_tensor(g), torch.as_tensor(p3),
                               choice=torch.as_tensor(choice, dtype=torch.long))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_per_sample_equals_jax_for_the_jax_choice():
    g, p3 = _inputs(1)
    seeds = np.arange(100, 112, dtype=np.int32)
    base = jax.random.PRNGKey(0)
    want = jgmm.sample_gmm_batch_per_sample(base, jnp.asarray(seeds), jnp.asarray(g), jnp.asarray(p3))
    # the kernels JAX picked, read back from its mean_uv
    choice = np.argmax((np.asarray(want[2])[:, :, None, :] == g[..., 1:3]).all(-1), axis=-1)
    got = gmm.sample_gmm_batch_per_sample(0, torch.as_tensor(seeds), torch.as_tensor(g),
                                          torch.as_tensor(p3), choice=torch.as_tensor(choice))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_sample_shapes_and_noise_scale():
    g, p3 = _inputs(2)
    gen = torch.Generator().manual_seed(0)
    uvxyz, ns, p2 = gmm.sample_gmm_batch(gen, torch.as_tensor(g), torch.as_tensor(p3))
    assert uvxyz.shape == ns.shape == (12, 17, 5) and p2.shape == (12, 17, 2)
    np.testing.assert_array_equal(uvxyz[..., 2:].numpy(), p3)
    np.testing.assert_array_equal(ns[..., 2:].numpy(), np.ones_like(p3))
    # every (mean, var) pair is one of the frame's kernels
    hit = ((uvxyz[..., None, :2].numpy() == g[..., 1:3]) & (ns[..., None, :2].numpy() == g[..., 3:5]))
    assert hit.all(-1).any(-1).all()


@pytest.mark.parametrize("draw", ["batch", "per_sample"])
def test_categorical_frequencies(draw):
    """Kernel k is drawn with probability w_k / Σw (zero weights clamp to 1e-12)."""
    w = np.array([0.5, 0.25, 0.0, 0.15, 0.1], np.float32)
    n = 20000
    g = np.zeros((n, 1, 5, 5), np.float32)
    g[..., 0] = w
    g[..., 1] = np.arange(5)  # mean_u names the kernel
    gt, p3 = torch.as_tensor(g), torch.zeros(n, 1, 3)
    if draw == "batch":
        _, _, p2 = gmm.sample_gmm_batch(torch.Generator().manual_seed(7), gt, p3)
    else:
        _, _, p2 = gmm.sample_gmm_batch_per_sample(5, torch.arange(n), gt, p3)
    freq = np.bincount(p2[:, 0, 0].numpy().astype(int), minlength=5) / n
    sigma = np.sqrt(w * (1 - w) / n)
    assert (np.abs(freq - w) <= 4 * sigma + 1e-9).all(), (freq, w)


def test_per_sample_draw_ignores_the_batching():
    g, p3 = _inputs(3, b=10)
    seeds = torch.arange(40, 50)
    whole = gmm.sample_gmm_batch_per_sample(9, seeds, torch.as_tensor(g), torch.as_tensor(p3))
    perm = torch.tensor([7, 2, 9, 0])
    part = gmm.sample_gmm_batch_per_sample(9, seeds[perm], torch.as_tensor(g)[perm],
                                           torch.as_tensor(p3)[perm])
    for a, b in zip(whole, part):
        assert torch.equal(a[perm], b)
    other = gmm.sample_gmm_batch_per_sample(10, seeds, torch.as_tensor(g), torch.as_tensor(p3))
    assert not torch.equal(other[2], whole[2])


def test_gmm_mean_pose_2d_matches_jax():
    g, _ = _inputs(4)
    want = np.asarray(jgmm.gmm_mean_pose_2d(jnp.asarray(g)))
    np.testing.assert_allclose(gmm.gmm_mean_pose_2d(torch.as_tensor(g)).numpy(), want, atol=1e-6)


@pytest.mark.parametrize("n", [1, 8, 9])
def test_antithetic_timesteps_pairing(n):
    gen = torch.Generator().manual_seed(n)
    t = antithetic_timesteps(gen, n, 51)
    half = n // 2 + 1
    assert t.shape == (n,) and t.dtype == torch.int64
    assert int(t.min()) >= 0 and int(t.max()) <= 50
    # element half+i mirrors element i, as jnp.concatenate([t, T-1-t])[:n]
    assert torch.equal(t[half:], 50 - t[:n - half])


def test_antithetic_timesteps_uniform():
    t = antithetic_timesteps(torch.Generator().manual_seed(0), 40000, 51)
    freq = np.bincount(t.numpy(), minlength=51) / 40000
    assert np.abs(freq - 1 / 51).max() < 4 * np.sqrt((1 / 51) * (50 / 51) / 40000)
