"""Port GCNDiff / GCNPose / layers vs the Flax modules, through state_dict_from_flax."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffpose_tpu.graph import H36M_EDGES, cheb_basis_from_edges
from diffpose_tpu.models import GCNDiff as JGCNDiff
from diffpose_tpu.models import GCNPose as JGCNPose
from diffpose_tpu.models import convert as jconvert
from diffpose_tpu.models import layers as jlayers
from diffpose_tpu_torch.models import GCNDiff, GCNPose, convert, layers

BASIS = cheb_basis_from_edges(17, H36M_EDGES)
CONFIGS = [dict(hid_dim=32, num_layers=2, num_heads=4),
           dict(hid_dim=96, num_layers=5, num_heads=4)]


def perturbed(params, seed):
    """Flax params with every leaf moved off its init (identity adjacency,
    unit LayerNorm, zero biases), so that every term of the forward is live."""
    rng = np.random.default_rng(seed)

    def move(path, x):
        x = np.asarray(x)
        if "a_hat" in jax.tree_util.keystr(path):
            return x + rng.uniform(0, 0.1, x.shape).astype(np.float32)
        return x + 0.05 * rng.normal(size=x.shape).astype(np.float32)

    return jax.tree_util.tree_map_with_path(move, params)


def flax_pair(cfg, seed, with_temb):
    if with_temb:
        jm = JGCNDiff(basis=BASIS, **cfg)
        params = jm.init({"params": jax.random.PRNGKey(seed)},
                         jnp.zeros((2, 17, 5)), jnp.zeros((2,)))["params"]
        tm = GCNDiff(BASIS, **cfg)
    else:
        jm = JGCNPose(basis=BASIS, **cfg)
        params = jm.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((2, 17, 2)))["params"]
        tm = GCNPose(BASIS, **cfg)
    params = perturbed(params, seed)
    sd = convert.state_dict_from_flax(params, with_temb=with_temb,
                                      num_layers=cfg["num_layers"], hid_dim=cfg["hid_dim"])
    tm.load_state_dict(sd, strict=True)
    return jm, params, tm.eval()


@pytest.mark.parametrize("cfg", CONFIGS, ids=["hid32x2", "hid96x5"])
def test_gcndiff_matches_flax(rng, cfg):
    jm, params, tm = flax_pair(cfg, 0, with_temb=True)
    x = rng.normal(size=(4, 17, 5)).astype(np.float32)
    t = np.array([0.0, 12.0, 30.0, 50.0], np.float32)
    mask = np.ones((1, 1, 17), np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t), jnp.asarray(mask)))
    with torch.no_grad():
        got = tm(torch.as_tensor(x), torch.as_tensor(t), torch.as_tensor(mask)).numpy()
        unmasked = tm(torch.as_tensor(x), torch.as_tensor(t)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5)
    np.testing.assert_allclose(unmasked, want, atol=5e-5)


@pytest.mark.parametrize("cfg", CONFIGS, ids=["hid32x2", "hid96x5"])
def test_gcnpose_matches_flax(rng, cfg):
    jm, params, tm = flax_pair(cfg, 1, with_temb=False)
    x = rng.normal(size=(4, 17, 2)).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = tm(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5)


@pytest.mark.parametrize("with_temb", [True, False], ids=["gcndiff", "gcnpose"])
def test_state_dict_names_and_shapes(with_temb):
    cfg = CONFIGS[0]
    _, params, tm = flax_pair(cfg, 2, with_temb)
    want = jconvert.params_to_torch_state(params, num_layers=cfg["num_layers"], with_temb=with_temb,
                                          prefix="", hid_dim=cfg["hid_dim"])
    got = convert.state_dict_from_flax(params, with_temb=with_temb,
                                       num_layers=cfg["num_layers"], hid_dim=cfg["hid_dim"])
    assert sorted(got) == sorted(want) == sorted(tm.state_dict())
    for k, v in want.items():
        assert tuple(got[k].shape) == v.shape, k
        np.testing.assert_array_equal(got[k].numpy(), v)


def test_checkpoint_roundtrip(tmp_path, rng):
    """save_torch_states writes the reference list with `module.` names: the
    JAX loader reads it back to the same params, the port's strips the prefix."""
    cfg = CONFIGS[0]
    jm, params, tm = flax_pair(cfg, 3, with_temb=True)
    path = str(tmp_path / "ckpt.pth")
    convert.save_torch_states(path, tm.state_dict(), epoch=7, step=70, ema_state=tm.state_dict())

    model_state, _, epoch, step, ema_state = jconvert.load_torch_states(path)
    assert (epoch, step) == (7, 70) and all(k.startswith("module.") for k in model_state)
    back = jconvert.torch_state_to_params(model_state, num_layers=cfg["num_layers"], with_temb=True)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           jax.tree_util.tree_map(np.asarray, params))

    model_state, _, epoch, step, ema_state = convert.load_torch_states(path)
    assert (epoch, step) == (7, 70)
    fresh = GCNDiff(BASIS, **cfg).eval()
    fresh.load_state_dict(model_state, strict=True)
    x = torch.as_tensor(rng.normal(size=(3, 17, 5)).astype(np.float32))
    t = torch.tensor([0.0, 5.0, 12.0])
    with torch.no_grad():
        assert torch.equal(fresh(x, t), tm(x, t))
    assert sorted(ema_state) == sorted(tm.state_dict())


@pytest.mark.parametrize("dim", [96, 33])
def test_timestep_embedding(dim):
    t = np.array([0.0, 1.0, 12.0, 50.0], np.float32)
    want = np.asarray(jlayers.timestep_embedding(jnp.asarray(t), dim))
    got = layers.timestep_embedding(torch.as_tensor(t), dim).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_attention_mask_fill(rng):
    """Masked keys get −1e9 before the softmax, as in the reference."""
    jm = jlayers.MultiHeadAttention(num_heads=4)
    x = rng.normal(size=(2, 17, 32)).astype(np.float32)
    params = perturbed(jm.init(jax.random.PRNGKey(4), jnp.asarray(x))["params"], 4)
    mask = np.ones((2, 1, 17), np.float32)
    mask[0, 0, 3:9] = 0
    mask[1, 0, 11:] = 0
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask)))
    tm = layers.MultiHeadAttention(32, 4).eval()
    with torch.no_grad():
        for lin, name in zip(tm.linears, ("q", "k", "v", "out")):
            lin.weight.copy_(torch.as_tensor(np.asarray(params[name]["kernel"]).T))
            lin.bias.copy_(torch.as_tensor(np.asarray(params[name]["bias"])))
        got = tm(torch.as_tensor(x), torch.as_tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_layer_norm_bessel(rng):
    x = rng.normal(size=(3, 17, 8)).astype(np.float32) * 3 + 1
    want = np.asarray(jlayers.TorchStyleLayerNorm().apply(
        {"params": {"scale": np.full(8, 1.5, np.float32), "bias": np.full(8, 0.25, np.float32)}},
        jnp.asarray(x)))
    ln = layers.TorchStyleLayerNorm(8)
    with torch.no_grad():
        ln.a_2.fill_(1.5)
        ln.b_2.fill_(0.25)
        got = ln(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6)
