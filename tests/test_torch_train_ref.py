"""Plain PyTorch train forward (explicit dropout masks) vs the JAX package:
its pure-JAX reference, its Pallas forward kernel in interpret mode, and
jax.grad for every parameter."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffpose_tpu.ops import train_ref as jref
from diffpose_tpu.ops.pallas_denoiser import _prep_weights
from diffpose_tpu.ops.pallas_train import STACK_KEYS, build_pallas_train_stack, kernel_masks
from diffpose_tpu_torch.models import convert
from diffpose_tpu_torch.ops import fused_train as ft
from diffpose_tpu_torch.ops import train_ref as tr
from diffpose_tpu_torch.ops.fused_denoiser import prepare_weights
from test_torch_models import BASIS, CONFIGS, flax_pair

SMALL, FULL = CONFIGS
GRAD_ABS, GRAD_REL = 1e-5, 1e-3   # tests/test_pallas_train.py:64-71


def numpy_masks(rng, cfg, batch, rates=None):
    """Joint-major 0/1 masks as the JAX package lays them out."""
    p_probs, p_sub, p_cheb = rates or (0.1, 0.25, 0.1)
    l, h, hd, n = cfg["num_layers"], cfg["num_heads"], cfg["hid_dim"], 17

    def bern(rate, shape):
        return (rng.random(shape) < 1.0 - rate).astype(np.float32)

    return jref.DropoutMasks(
        probs=bern(p_probs, (l, n, n, batch, h)), attn_out=bern(p_sub, (l, n, batch, hd)),
        gnet_out=bern(p_sub, (l, n, batch, hd)), cheb1=bern(p_cheb, (l, n, batch, hd)),
        cheb2=bern(p_cheb, (l, n, batch, hd)))


def to_port_masks(m) -> tr.DropoutMasks:
    """Joint-major JAX masks → the port's batch-major layout."""
    return tr.DropoutMasks(
        probs=torch.as_tensor(np.transpose(m.probs, (0, 3, 4, 1, 2)).copy()),
        **{k: torch.as_tensor(np.transpose(getattr(m, k), (0, 2, 1, 3)).copy())
           for k in ("attn_out", "gnet_out", "cheb1", "cheb2")})


def jax_masks(m):
    return jref.DropoutMasks(*(jnp.asarray(v) for v in m))


def grads_close(got_tree, want_tree):
    flat_w, _ = jax.tree_util.tree_flatten_with_path(want_tree)
    flat_g, _ = jax.tree_util.tree_flatten_with_path(got_tree)
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, want), (_, got) in zip(flat_w, flat_g):
        want, got = np.asarray(want), np.asarray(got)
        assert want.shape == got.shape, jax.tree_util.keystr(path)
        absd = np.abs(want - got).max()
        if absd < GRAD_ABS:
            continue
        assert absd / (np.abs(want).max() + 1e-8) < GRAD_REL, (jax.tree_util.keystr(path), absd)


@pytest.mark.parametrize("cfg", CONFIGS, ids=["hid32x2", "hid96x5"])
def test_layers_forward_matches_jax_reference(rng, cfg):
    _, params, tm = flax_pair(cfg, 0, with_temb=True)
    b, hid, L = 4, cfg["hid_dim"], cfg["num_layers"]
    h = rng.normal(size=(b, 17, hid)).astype(np.float32)
    tp = rng.normal(size=(L, b, hid)).astype(np.float32)
    m = numpy_masks(rng, cfg, b)
    jw, _, _, _ = _prep_weights(params, BASIS, L, cfg["num_heads"], hid)
    want = jref.layers_forward(jw, jnp.asarray(h.transpose(1, 0, 2)), jnp.asarray(tp), jax_masks(m),
                               basis=BASIS, **cfg)
    w = prepare_weights(tm, device="cpu")
    with torch.no_grad():
        got = tr.layers_forward(w, torch.as_tensor(h), torch.as_tensor(tp), to_port_masks(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(1, 0, 2), atol=5e-5)


def test_train_forward_matches_jax_reference(rng):
    _, params, tm = flax_pair(FULL, 1, with_temb=True)
    x = rng.normal(size=(4, 17, 5)).astype(np.float32)
    t = np.array([0.0, 7.0, 30.0, 50.0], np.float32)
    m = numpy_masks(rng, FULL, 4)
    want = jref.train_forward(params, BASIS, jnp.asarray(x), jnp.asarray(t), jax_masks(m), **FULL)
    with torch.no_grad():
        got = tr.train_forward(tm, torch.as_tensor(x), torch.as_tensor(t), to_port_masks(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)


def test_rates_zero_is_the_module_forward(rng):
    """With every rate 0 the masked forward is GCNDiff's own: the Flax
    module applied with train=True and dropout that drops nothing."""
    jm, params, tm = flax_pair(FULL, 2, with_temb=True)
    x = rng.normal(size=(3, 17, 5)).astype(np.float32)
    t = np.array([1.0, 12.0, 40.0], np.float32)
    rates = (0.0, 0.0, 0.0)
    ones = tr.make_dropout_masks(torch.Generator().manual_seed(0), n_pts=17, batch=3, rates=rates,
                                 **FULL)
    assert all(bool((v == 1).all()) for v in ones)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = tr.train_forward(tm, torch.as_tensor(x), torch.as_tensor(t), ones, rates=rates)
        module = tm(torch.as_tensor(x), torch.as_tensor(t))
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)
    np.testing.assert_allclose(got.numpy(), module.numpy(), atol=5e-5)


def test_layers_forward_matches_pallas_interpret(rng):
    """The Pallas forward kernel itself, in interpret mode, B=16, full width."""
    _, params, tm = flax_pair(FULL, 3, with_temb=True)
    b, hid, L = 16, FULL["hid_dim"], FULL["num_layers"]
    h = rng.normal(size=(b, 17, hid)).astype(np.float32)
    tp = rng.normal(size=(L, b, hid)).astype(np.float32)
    m = numpy_masks(rng, FULL, b)
    jw, _, _, _ = _prep_weights(params, BASIS, L, FULL["num_heads"], hid)
    stack = build_pallas_train_stack(BASIS, block_b_fwd=16, block_b_bwd=16, group=4,
                                     precision=None, interpret=True, **FULL)
    want, jst = stack.run_fwd({k: jw[k] for k in STACK_KEYS}, jnp.asarray(h.transpose(1, 0, 2)),
                              jnp.asarray(tp), kernel_masks(jax_masks(m), hid // FULL["num_heads"]))
    w = prepare_weights(tm, device="cpu")
    with torch.no_grad():
        got, st = tr.layers_forward(w, torch.as_tensor(h), torch.as_tensor(tp), to_port_masks(m),
                                    return_stashes=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(1, 0, 2), atol=1e-4)
    for k in ("ha", "hb", "y1", "att", "r1", "rc1", "rd1"):  # the TPU kernel's stash set
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]).transpose(0, 2, 1, 3),
                                   atol=1e-4, err_msg=k)


def test_parameter_gradients_match_jax_grad(rng):
    _, params, tm = flax_pair(FULL, 4, with_temb=True)
    b = 6
    x = rng.normal(size=(b, 17, 5)).astype(np.float32)
    t = rng.integers(0, 51, size=b).astype(np.float32)
    e = rng.normal(size=(b, 17, 5)).astype(np.float32)
    m = numpy_masks(rng, FULL, b)

    def loss_ref(p):
        out = jref.train_forward(p, BASIS, jnp.asarray(x), jnp.asarray(t), jax_masks(m), **FULL)
        return jnp.mean(jnp.sum((jnp.asarray(e) - out) ** 2, axis=(1, 2)))

    want = jax.jit(jax.grad(loss_ref))(params)
    out = tr.train_forward(tm, torch.as_tensor(x), torch.as_tensor(t), to_port_masks(m))
    loss = ((torch.as_tensor(e) - out) ** 2).sum(dim=(1, 2)).mean()
    names = [n for n, _ in tm.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(tm.parameters()))))
    got = convert.flax_from_state_dict(grads, with_temb=True, num_layers=FULL["num_layers"])
    grads_close(got, want)


def test_flax_from_state_dict_inverts_state_dict_from_flax():
    _, params, tm = flax_pair(SMALL, 5, with_temb=True)
    back = convert.flax_from_state_dict(tm.state_dict(), with_temb=True, num_layers=2)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           jax.tree_util.tree_map(np.asarray, params))
    _, pparams, pm = flax_pair(SMALL, 5, with_temb=False)
    back = convert.flax_from_state_dict(pm.state_dict(), with_temb=False, num_layers=2)
    jax.tree_util.tree_map(np.testing.assert_array_equal, back,
                           jax.tree_util.tree_map(np.asarray, pparams))


@pytest.mark.parametrize("rates", [None, (0.3, 0.5, 0.05)], ids=["reference", "override"])
def test_dropout_mask_keep_rates(rates):
    gen = torch.Generator().manual_seed(11)
    masks = tr.make_dropout_masks(gen, num_layers=2, n_pts=17, batch=64, num_heads=4, hid_dim=32,
                                  rates=rates)
    p_probs, p_sub, p_cheb = rates or (tr.RATE_ATTN_PROBS, tr.RATE_SUBLAYER, tr.RATE_CHEB)
    assert masks.probs.shape == (2, 64, 4, 17, 17) and masks.cheb2.shape == (2, 64, 17, 32)
    for m, rate in zip(masks, (p_probs, p_sub, p_sub, p_cheb, p_cheb)):
        assert set(m.unique().tolist()) <= {0.0, 1.0}
        sigma = np.sqrt(rate * (1 - rate) / m.numel())
        assert abs(float(m.mean()) - (1 - rate)) <= 3 * sigma
    assert (tr.RATE_ATTN_PROBS, tr.RATE_SUBLAYER, tr.RATE_CHEB) == (
        jref.RATE_ATTN_PROBS, jref.RATE_SUBLAYER, jref.RATE_CHEB)


def test_kernel_masks_layout_roundtrip(rng):
    m = to_port_masks(numpy_masks(rng, SMALL, 5))
    km = ft.kernel_masks(m)
    assert km["probs"].shape == (2, 5, 4, 17, 17) and km["probs"].dtype == torch.uint8
    assert km["cheb1"].shape == (2, 5, 17, 32) and all(v.is_contiguous() for v in km.values())
    back = ft.masks_from_kernel(km)
    for a, b in zip(back, m):
        assert torch.equal(a, b)
    # uint8 masks drawn directly pass through unchanged
    drawn = tr.make_dropout_masks(torch.Generator().manual_seed(0), num_layers=2, n_pts=17, batch=5,
                                  num_heads=4, hid_dim=32, dtype=torch.uint8)
    assert all(ft.kernel_masks(drawn)[k] is getattr(drawn, k) for k in ft.MASK_KEYS)
