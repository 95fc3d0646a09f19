"""The fused train stack on the CPU: the autograd.Function over the plain
forward and the hand-written plain backward (the formulas the CUDA kernel
implements), vs autograd of the plain forward and vs jax.grad.

The CUDA kernels themselves run only on the card; chip_smoke.py holds them
against these plain versions there.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffpose_tpu.ops import train_ref as jref
from diffpose_tpu.ops.pallas_train import _terms_transposed
from diffpose_tpu_torch.models import convert
from diffpose_tpu_torch.ops import fused_denoiser as fd
from diffpose_tpu_torch.ops import fused_train as ft
from diffpose_tpu_torch.ops import train_ref as tr
from test_torch_models import BASIS, CONFIGS, flax_pair
from test_torch_train_ref import grads_close, jax_masks, numpy_masks, to_port_masks

SMALL, FULL = CONFIGS
GRAD_ABS, GRAD_REL = 1e-5, 1e-3


def close(got, want, what):
    d = float((got - want).abs().max())
    assert d < GRAD_ABS or d / (float(want.abs().max()) + 1e-8) < GRAD_REL, (what, d)


def stack_case(rng, cfg, batch, seed, rates=None):
    _, params, tm = flax_pair(cfg, seed, with_temb=True)
    w = fd.prepare_weights(tm, device="cpu")
    hid, L = cfg["hid_dim"], cfg["num_layers"]
    h0 = torch.as_tensor(rng.normal(size=(batch, 17, hid)).astype(np.float32))
    tp = torch.as_tensor(rng.normal(size=(L, batch, hid)).astype(np.float32))
    dd5 = torch.as_tensor(rng.normal(size=(batch, 17, hid)).astype(np.float32))
    return params, tm, w, h0, tp, dd5, to_port_masks(numpy_masks(rng, cfg, batch, rates))


@pytest.mark.parametrize("rates", [None, (0.3, 0.4, 0.2)], ids=["reference", "override"])
def test_plain_backward_matches_autograd(rng, rates):
    _, _, w, h0, tp, dd5, masks = stack_case(rng, FULL, 5, 0, rates)
    wr = dict(w, **{k: w[k].clone().requires_grad_() for k in ft.STACK_KEYS})
    h0r, tpr = h0.clone().requires_grad_(), tp.clone().requires_grad_()
    d5, st = tr.layers_forward(wr, h0r, tpr, masks, rates=rates, return_stashes=True)
    want = torch.autograd.grad(d5, [h0r, tpr, *[wr[k] for k in ft.STACK_KEYS]], dd5)
    st = {k: v.detach() for k, v in st.items()}
    da0, dtp, ds = ft.stack_bwd_plain(w, masks, st, dd5, rates=rates)
    close(da0, want[0], "dA0")
    close(dtp, want[1], "dtp")
    grads = ft.weight_grads(w, st, ds)
    for k, g in zip(ft.STACK_KEYS, want[2:]):
        assert grads[k].shape == w[k].shape, k
        close(grads[k], g, k)
    for k in ft.DSTASH_KEYS:
        assert ds[k].shape == (5, 5, 17, ft._DSTASH_WIDTH.get(k, 1) * 96), k


def test_d_stashes_are_the_preactivation_gradients(rng):
    """dqkv, do1, df2: gradients of the loss with respect to qkv, o1 and f2,
    read from autograd by perturbing the biases they are added to."""
    _, _, w, h0, tp, dd5, masks = stack_case(rng, SMALL, 3, 1)
    wr = dict(w, **{k: w[k].clone().requires_grad_() for k in ("bqkv", "bao", "bfc2", "bfc1")})
    d5, st = tr.layers_forward(wr, h0, tp, masks, return_stashes=True)
    want = torch.autograd.grad(d5, [wr["bqkv"], wr["bao"], wr["bfc2"], wr["bfc1"]], dd5)
    _, _, ds = ft.stack_bwd_plain(w, masks, {k: v.detach() for k, v in st.items()}, dd5)
    for key, g in zip(("dqkv", "do1", "df2", "df1"), want):
        close(ds[key].sum(dim=(1, 2)), g, key)


def test_ln_bwd_and_cheb_bwd_match_autograd(rng):
    x = torch.as_tensor(rng.normal(size=(4, 17, 32)).astype(np.float32) * 2 + 0.5).requires_grad_()
    g = torch.as_tensor(rng.normal(size=(4, 17, 32)).astype(np.float32))
    scale = torch.as_tensor(rng.normal(size=32).astype(np.float32))
    y = fd._layer_norm(x, scale, torch.zeros(32))
    np.testing.assert_allclose(ft._ln_bwd(g, x.detach(), scale).numpy(),
                               torch.autograd.grad(y, x, g)[0].numpy(), atol=1e-5)
    basis = torch.as_tensor(BASIS)
    assert float((basis - basis.transpose(1, 2)).abs().max()) > 0.1  # the mixes are not symmetric
    wcat = torch.as_tensor(rng.normal(size=(32, 3 * 24)).astype(np.float32))
    gy = torch.as_tensor(rng.normal(size=(4, 17, 24)).astype(np.float32))
    y = fd._cheb(x, wcat, torch.zeros(24), basis)
    np.testing.assert_allclose(ft._cheb_bwd_data(gy, wcat, basis).numpy(),
                               torch.autograd.grad(y, x, gy)[0].numpy(), atol=1e-5)


def test_transposed_term_list_covers_the_basis():
    ptr, idx, val = fd.sparse_terms_transposed(BASIS.astype(np.float64))
    dense = np.zeros_like(BASIS)
    for k in range(3):
        for m in range(17):
            for e in range(ptr[k * 17 + m], ptr[k * 17 + m + 1]):
                dense[k, idx[e], m] = val[e]
    np.testing.assert_array_equal(dense, BASIS)
    tpu = _terms_transposed(BASIS.astype(np.float64))
    for k in range(3):
        for m in range(17):
            ours = [int(idx[e]) for e in range(ptr[k * 17 + m], ptr[k * 17 + m + 1])]
            assert ours == [j for j, _ in tpu[k][m]]


@pytest.mark.parametrize("cfg", CONFIGS, ids=["hid32x2", "hid96x5"])
def test_fused_gradients_match_plain_autograd(rng, cfg):
    _, _, tm = flax_pair(cfg, 2, with_temb=True)
    b = 5
    x = torch.as_tensor(rng.normal(size=(b, 17, 5)).astype(np.float32))
    t = torch.as_tensor(rng.integers(0, 51, size=b).astype(np.float32))
    e = torch.as_tensor(rng.normal(size=(b, 17, 5)).astype(np.float32))
    masks = to_port_masks(numpy_masks(rng, cfg, b))
    stack = ft.build_train_stack(BASIS, **cfg)
    params = list(tm.parameters())
    out_p = tr.train_forward(tm, x, t, masks)
    g_p = torch.autograd.grad(((e - out_p) ** 2).sum(dim=(1, 2)).mean(), params)
    out_f = ft.fused_train_forward(tm, x, t, masks, stack)
    g_f = torch.autograd.grad(((e - out_f) ** 2).sum(dim=(1, 2)).mean(), params)
    np.testing.assert_allclose(out_f.detach().numpy(), out_p.detach().numpy(), atol=1e-6)
    for (name, _), a, b_ in zip(tm.named_parameters(), g_f, g_p):
        close(a, b_, name)
    # q's weight and A_hat are reached through the differentiable weight prep
    names = [n for n, _ in tm.named_parameters()]
    for key in ("atten_layers.0.self_attn.linears.0.weight", "atten_layers.1.feed_forward.A_hat"):
        assert float(g_f[names.index(key)].abs().max()) > 0, key


def test_fused_gradients_match_jax_grad(rng):
    _, params, tm = flax_pair(FULL, 3, with_temb=True)
    b = 6
    x = rng.normal(size=(b, 17, 5)).astype(np.float32)
    t = rng.integers(0, 51, size=b).astype(np.float32)
    e = rng.normal(size=(b, 17, 5)).astype(np.float32)
    m = numpy_masks(rng, FULL, b)

    def loss_ref(p):
        out = jref.train_forward(p, BASIS, jnp.asarray(x), jnp.asarray(t), jax_masks(m), **FULL)
        return jnp.mean(jnp.sum((jnp.asarray(e) - out) ** 2, axis=(1, 2)))

    want = jax.jit(jax.grad(loss_ref))(params)
    stack = ft.build_train_stack(BASIS, **FULL)
    out = ft.fused_train_forward(tm, torch.as_tensor(x), torch.as_tensor(t), to_port_masks(m), stack)
    loss = ((torch.as_tensor(e) - out) ** 2).sum(dim=(1, 2)).mean()
    names = [n for n, _ in tm.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(tm.parameters()))))
    grads_close(convert.flax_from_state_dict(grads, with_temb=True, num_layers=5), want)


def test_cpu_calls_launch_nothing(rng):
    _, _, w, h0, tp, dd5, masks = stack_case(rng, SMALL, 2, 4)
    stack = ft.build_train_stack(BASIS, **SMALL)
    ft.stack_fwd.launches = ft.stack_bwd.launches = 0
    km = ft.kernel_masks(masks)
    d5, st = stack.run_fwd(w, h0, tp, km)
    da0, dtp, ds = stack.run_bwd(w, km, st, dd5)
    assert d5.shape == da0.shape == (2, 17, 32) and dtp.shape == (2, 2, 32)
    assert sorted(st) == sorted(tr.STASH_KEYS) and sorted(ds) == sorted(ft.DSTASH_KEYS)
    assert (ft.stack_fwd.launches, ft.stack_bwd.launches) == (0, 0)


def test_kernel_wrappers_reject_what_they_do_not_take(rng):
    _, _, ws, h0, tp, dd5, masks = stack_case(rng, SMALL, 2, 5)
    km = ft.kernel_masks(masks)
    with pytest.raises(ValueError, match="built for"):
        ft._launch_fwd(ws, h0, tp, km, (1.0, 1.0, 1.0))
    _, _, wf, h0, tp, dd5, masks = stack_case(rng, FULL, 2, 5)
    km = ft.kernel_masks(masks)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ft._launch_fwd(wf, h0, tp, km, (1.0, 1.0, 1.0))
    with pytest.raises(ValueError, match="CUDA tensors"):
        ft._launch_bwd(wf, km, {}, dd5, (1.0, 1.0, 1.0))
    stack = ft.build_train_stack(BASIS, **SMALL)
    with pytest.raises(ValueError, match="built for"):
        stack(wf, h0, tp, masks)
    other = ft.build_train_stack(BASIS[:, ::-1, ::-1].copy(), **FULL)
    with pytest.raises(ValueError, match="another Chebyshev basis"):
        other(wf, h0, tp, masks)


def test_differentiable_weight_prep_equals_the_snapshot():
    _, _, tm = flax_pair(SMALL, 6, with_temb=True)
    snap = fd.prepare_weights(tm, device="cpu")
    live = fd.prepare_weights(tm, device="cpu", differentiable=True)
    for k in ft.STACK_KEYS + ("win", "bin", "wout", "bout", "wtp", "btp"):
        assert torch.equal(snap[k], live[k].detach()), k
        assert live[k].requires_grad and not snap[k].requires_grad, k
    assert live["cheb_ptr"] is snap["cheb_ptr"]  # graph constants are cached
