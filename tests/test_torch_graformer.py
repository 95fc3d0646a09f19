"""Port GraFormer / ChebNet / PositionwiseFeedForward / GraphConvBlock vs the
Flax modules, with the weights carried across by the converters."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffpose_tpu.graph import GAN_EDGES, H36M_EDGES, cheb_basis_from_edges
from diffpose_tpu.models import layers as jlayers
from diffpose_tpu.models.graformer import GraFormer as JGraFormer
from diffpose_tpu_torch.models import GraFormer, convert, layers
from test_torch_models import perturbed

CFG = dict(hid_dim=32, num_layers=2, num_heads=4)
GRAPHS = {21: cheb_basis_from_edges(21, GAN_EDGES), 17: cheb_basis_from_edges(17, H36M_EDGES)}


def graformer_pair(n_pts, seed):
    basis = GRAPHS[n_pts]
    jm = JGraFormer(basis=basis, n_pts=n_pts, **CFG)
    params = jm.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((2, n_pts, 2)))["params"]
    params = perturbed(params, seed)
    tm = GraFormer(basis, n_pts=n_pts, **CFG)
    tm.load_state_dict(convert.state_dict_from_flax_graformer(params, num_layers=CFG["num_layers"]),
                       strict=True)
    return jm, params, tm.eval()


def two_joints_masked(bsz, n_pts):
    mask = np.ones((bsz, 1, n_pts), np.float32)
    mask[:, :, [3, n_pts - 2]] = 0.0
    return mask


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
@pytest.mark.parametrize("n_pts", [21, 17])
def test_graformer_matches_flax(rng, n_pts, masked):
    jm, params, tm = graformer_pair(n_pts, n_pts)
    x = rng.normal(size=(5, n_pts, 2)).astype(np.float32)
    mask = two_joints_masked(5, n_pts) if masked else None
    apply = jax.jit(lambda p, x, m: jm.apply({"params": p}, x, m))
    want = np.asarray(apply(params, jnp.asarray(x), None if mask is None else jnp.asarray(mask)))
    with torch.no_grad():
        got = tm(torch.as_tensor(x), None if mask is None else torch.as_tensor(mask)).numpy()
    assert got.shape == (5, n_pts, 3)
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_graformer_param_grads_match_jax(rng):
    """Eval-mode gradients of one scalar loss, leaf by leaf: within 5e-5
    absolute or 1e-4 of the leaf's largest entry."""
    jm, params, tm = graformer_pair(21, 3)
    x = rng.normal(size=(4, 21, 2)).astype(np.float32)
    mask = two_joints_masked(4, 21)
    r = rng.normal(size=(4, 21, 3)).astype(np.float32)

    def loss(p):
        return jnp.sum(jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(mask)) * r)

    want = jax.jit(jax.grad(loss))(params)
    (tm(torch.as_tensor(x), torch.as_tensor(mask)) * torch.as_tensor(r)).sum().backward()
    got = convert.flax_graformer_from_state_dict(
        {k: p.grad for k, p in tm.named_parameters()}, num_layers=CFG["num_layers"])
    flat_want = dict(jax.tree_util.tree_leaves_with_path(want))
    flat_got = dict(jax.tree_util.tree_leaves_with_path(got))
    assert sorted(map(str, flat_got)) == sorted(map(str, flat_want))
    for path, w in flat_want.items():
        w = np.asarray(w)
        g = flat_got[path]
        assert np.abs(g - w).max() <= max(5e-5, 1e-4 * np.abs(w).max()), jax.tree_util.keystr(path)


def test_graformer_converter_roundtrip():
    _, params, tm = graformer_pair(21, 4)
    assert not any(k.startswith("temb") for k in tm.state_dict())
    back = convert.flax_graformer_from_state_dict(tm.state_dict(), num_layers=CFG["num_layers"])
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           jax.tree_util.tree_map(np.asarray, params))


@pytest.mark.parametrize("rate", [None, 0.1], ids=["nodropout", "dropout0.1"])
def test_chebnet_matches_flax(rng, rate):
    basis = GRAPHS[21]
    jm = jlayers.ChebNet(3, 16, basis, rate)
    x = rng.normal(size=(4, 21, 6)).astype(np.float32)
    params = perturbed(jm.init({"params": jax.random.PRNGKey(5)}, jnp.asarray(x))["params"], 5)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = layers.ChebNet(6, 3, 16, basis, rate)
    tm.load_state_dict(convert.state_dict_from_flax_chebnet(params), strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_positionwise_feed_forward_matches_flax(rng):
    jm = jlayers.PositionwiseFeedForward(64, 0.1)
    x = rng.normal(size=(3, 21, 32)).astype(np.float32)
    params = jm.init({"params": jax.random.PRNGKey(6)}, jnp.asarray(x))["params"]
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = layers.PositionwiseFeedForward(32, 64, 0.1)
    tm.load_state_dict(convert.state_dict_from_flax_ffn(params), strict=True)
    assert sorted(tm.state_dict()) == ["w_1.bias", "w_1.weight", "w_2.bias", "w_2.weight"]
    with torch.no_grad():
        got = tm.eval()(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5)


@pytest.mark.parametrize("rate", [None, 0.25], ids=["none", "0.25"])
def test_graph_conv_block_matches_flax(rng, rate):
    """``dropout_rate=None`` builds (it raised a TypeError at construction
    before) and is ``relu(gconv(x))`` with no dropout module; a rate keeps
    the reference's relu → dropout → relu and the state-dict names."""
    basis = GRAPHS[17]
    jm = jlayers.GraphConvBlock(8, basis, rate)
    x = rng.normal(size=(4, 17, 5)).astype(np.float32)
    params = perturbed(jm.init({"params": jax.random.PRNGKey(7)}, jnp.asarray(x))["params"], 7)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = layers.GraphConvBlock(5, 8, basis, rate)
    assert (tm.dropout is None) == (rate is None)
    tm.load_state_dict({"gconv.weight": torch.as_tensor(np.asarray(params["gconv"]["w"])[:, None]),
                        "gconv.bias": torch.as_tensor(np.asarray(params["gconv"]["b"])[None, None])},
                       strict=True)
    with torch.no_grad():
        got = tm.eval()(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5)
