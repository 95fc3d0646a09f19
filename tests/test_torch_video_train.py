"""Port video training forward, train and eval steps vs the JAX package
(diffpose_tpu/ops/pallas_video_train.py, train/video_steps.py), on the CPU,
where the train kernel pair runs as its plain version (the hand-written
backward included)."""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffpose_tpu.ops import train_ref as jref
from diffpose_tpu.ops.pallas_video_train import _temporal_block_train, make_pallas_video_train_fn
from diffpose_tpu.train.state import TrainState as JTrainState
from diffpose_tpu.train.video_steps import make_video_eval_step as j_make_eval_step
from diffpose_tpu_torch.data.video import synthetic_video_dataset
from diffpose_tpu_torch.diffusion import get_beta_schedule
from diffpose_tpu_torch.models import convert
from diffpose_tpu_torch.models.ema import ema_register
from diffpose_tpu_torch.ops import fused_train as ft
from diffpose_tpu_torch.ops import fused_video_full as fv
from diffpose_tpu_torch.ops import fused_video_train as fvt
from diffpose_tpu_torch.ops.fused_video import make_video_denoiser_fn
from diffpose_tpu_torch.ops.philox import philox_masks
from diffpose_tpu_torch.ops.train_ref import DropoutMasks, make_dropout_masks
from diffpose_tpu_torch.train import optim
from diffpose_tpu_torch.train.state import TrainState
from diffpose_tpu_torch.train.video_steps import make_video_eval_step, make_video_train_step
from test_torch_models import BASIS
from test_torch_video_models import inputs, video_pair

torch.set_num_threads(1)

BETAS = get_beta_schedule("linear", beta_start=1e-4, beta_end=1e-3, num_diffusion_timesteps=51)
SEQ = (0, 12)
ZERO = (0.0, 0.0, 0.0)


def masks_of(model, rows, rates, seed=0, dtype=torch.uint8):
    return make_dropout_masks(torch.Generator().manual_seed(seed), num_layers=model.num_layers,
                              n_pts=17, batch=rows, num_heads=4, hid_dim=model.hid_dim,
                              rates=rates, dtype=dtype)


def jax_masks_of(m):
    """The port's batch-major masks in the JAX package's joint-major layout."""
    return jref.DropoutMasks(
        probs=jnp.asarray(m.probs.permute(0, 3, 4, 1, 2).float().numpy()),
        **{k: jnp.asarray(getattr(m, k).permute(0, 2, 1, 3).float().numpy())
           for k in ("attn_out", "gnet_out", "cheb1", "cheb2")})


def grads_close(got, want):
    for (path, w), (_, g) in zip(jax.tree_util.tree_leaves_with_path(want),
                                 jax.tree_util.tree_leaves_with_path(got)):
        d = float(np.abs(np.asarray(g) - np.asarray(w)).max())
        assert d < 1e-5 or d / float(np.abs(np.asarray(w)).max()) < 1e-3, jax.tree_util.keystr(path)


def port_grads(tm, fn, x, t, masks, e):
    out = fn(torch.as_tensor(x), torch.as_tensor(t), masks, None)
    ((torch.as_tensor(e) - out) ** 2).sum(dim=(1, 2, 3)).mean().backward()
    return out.detach(), convert.flax_video_from_state_dict(
        {k: p.grad for k, p in tm.named_parameters()})


@pytest.mark.parametrize("frames", [4, 5], ids=["rows8", "rows10"])
def test_train_fn_at_rates_0_matches_the_module_and_its_gradients(rng, frames):
    """Forward against model.apply and gradients against jax.grad of it; 2
    windows of 5 frames give B·F = 10 rows, a ragged tile of the kernels."""
    jm, params, tm = video_pair(10, dropout_rate=0.0, frames=frames)
    x, t = inputs(rng, 2, frames)
    e = rng.normal(size=x.shape).astype(np.float32)

    def jloss(p):
        out = jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(t))
        return jnp.mean(jnp.sum((e - out) ** 2, axis=(1, 2, 3))), out

    (_, want), jgrads = jax.jit(jax.value_and_grad(jloss, has_aux=True))(params)
    fn = fvt.make_video_train_fn(tm, rates=ZERO)
    out, got = port_grads(tm, fn, x, t, masks_of(tm, 2 * frames, ZERO), e)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=2e-5)
    grads_close(got, jgrads)


def test_spatial_masks_reach_each_layer_as_in_the_jax_train_fn(rng):
    """The video rates with masks (temporal rate 0): gradients against
    jax.grad of the JAX train function over its pure-JAX twin stack, the
    same masks handed to both."""
    jm, params, tm = video_pair(11, dropout_rate=0.0)
    rates = fvt.video_dropout_rates(tm)
    assert rates == (0.1, 0.0, 0.1)
    x, t = inputs(rng, 2, tm.frames)
    e = rng.normal(size=x.shape).astype(np.float32)
    masks = masks_of(tm, 2 * tm.frames, rates, seed=3)
    basis = jnp.asarray(BASIS, jnp.float32)
    jfn = make_pallas_video_train_fn(jm, rates=rates, stack_override=lambda w, h0, tp, m: (
        jref.layers_forward(w, h0, tp, m, basis=basis, num_layers=1, num_heads=4, hid_dim=32,
                            rates=rates)))
    jm_masks = jax_masks_of(masks)
    jgrads = jax.jit(jax.grad(lambda p: jnp.mean(jnp.sum(
        (e - jfn(p, jnp.asarray(x), jnp.asarray(t), jm_masks, jax.random.PRNGKey(0))) ** 2,
        axis=(1, 2, 3)))))(params)
    _, got = port_grads(tm, fvt.make_video_train_fn(tm), x, t, masks, e)
    grads_close(got, jgrads)


def test_temporal_dropout_has_the_flax_semantics(rng):
    """temporal_block_train with the masks the JAX block draws from its key."""
    _, params, tm = video_pair(12, dropout_rate=0.3)
    x = rng.normal(size=(3, 5, 32)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    p = jax.tree_util.tree_map(jnp.asarray, params["temporal_0"])
    want = _temporal_block_train(p, jnp.asarray(x), 4, 0.3, key)
    shapes = ((3, 4, 5, 5), (3, 5, 32), (3, 5, 32))
    masks = tuple(torch.as_tensor(np.array(jax.random.bernoulli(k, 0.7, s)))
                  for k, s in zip(jax.random.split(key, 3), shapes))
    got = fvt.temporal_block_train(tm.layer(0)[2], torch.as_tensor(x), 0.3, masks)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-5)


def test_prng_layers_draw_from_their_own_wrapped_seeds(rng):
    seed = torch.tensor([2 ** 31 - 5], dtype=torch.int32)
    want = [int(np.array([2 ** 31 - 5], np.int32).astype(np.int64)[0] + i * 1000003) for i in range(4)]
    want = [((v + 2 ** 31) % 2 ** 32) - 2 ** 31 for v in want]
    assert [int(fvt.layer_seed(seed, i)) for i in range(4)] == want and want[1] < 0
    _, _, tm = video_pair(13)
    rates = fvt.video_dropout_rates(tm)
    x, t = (torch.as_tensor(v) for v in inputs(rng, 2, tm.frames))
    tmasks = fvt.make_temporal_masks(torch.Generator().manual_seed(1), num_layers=2, rows=34,
                                     frames=5, num_heads=4, hid_dim=32, rate=0.1)
    per_layer = [philox_masks(fvt.layer_seed(seed, i), num_layers=1, batch=10, n_pts=17,
                              num_heads=4, hid_dim=32, rates=rates) for i in range(2)]
    assert not torch.equal(per_layer[0].attn_out, per_layer[1].attn_out)
    masks = DropoutMasks(*(torch.cat(ms) for ms in zip(*per_layer)))
    with torch.no_grad():
        seeded = fvt.make_video_train_fn(tm, dropout="prng")(x, t, seed, tmasks)
        explicit = fvt.make_video_train_fn(tm)(
            x, t, DropoutMasks(*(m.to(torch.uint8) for m in masks)), tmasks)
    torch.testing.assert_close(seeded, explicit, rtol=0, atol=1e-6)


@pytest.mark.parametrize("dropout", ["masks", "prng"])
def test_fused_step_equals_the_plain_step(dropout):
    """One step each from the same draws: the kernel pair (its plain version
    here) against the plain twin; the EMA shadow moves, the step counts."""
    _, _, tm = video_pair(14)
    data = synthetic_video_dataset(2, tm.frames, seed=0)
    batch = {"poses_3d": data.poses_3d, "poses_2d_gmm": data.poses_2d_gmm}
    out = {}
    for impl in ("fused", "plain"):
        model = copy.deepcopy(tm)
        # eps 1e-4: at 1e-8 Adam turns the rounding noise of the gradients that
        # are 0 in exact arithmetic (the key biases) into steps of the full rate
        opt = optim.make_optimizer(model.parameters(), lr=1e-3, eps=1e-4)
        state = TrainState.create(model, opt, ema_register(model))
        step = make_video_train_step(model, opt, BETAS, impl=impl, device="cpu", dropout=dropout)
        draws = step.draw(batch, torch.Generator().manual_seed(5))
        assert draws.x_t.shape == (2, 5, 17, 5) and draws.t.shape == (2,)
        assert (draws.seed is not None) == (dropout == "prng") and draws.tmasks is not None
        ft.stack_fwd.launches = ft.stack_fwd_prng.launches = 0
        state, metrics = step.apply(state, draws)
        assert (ft.stack_fwd.launches, ft.stack_fwd_prng.launches) == (0, 0)
        out[impl] = (metrics, state)
    (mf, sf), (mp, sp) = out["fused"], out["plain"]
    np.testing.assert_allclose(float(mf["loss"]), float(mp["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(mf["grad_norm"]), float(mp["grad_norm"]), rtol=1e-4)
    for a, b in zip(sf.model.parameters(), sp.model.parameters()):
        torch.testing.assert_close(a, b, rtol=0, atol=2e-6)
    assert sf.step == 1 and any(not torch.equal(sf.ema_params[k], p)
                                for k, p in sf.model.named_parameters())


def one_component_windows(frames, windows=3):
    data = synthetic_video_dataset(windows, frames, seed=3)
    gmm = data.poses_2d_gmm.copy()
    gmm[..., 0] = 0.0
    gmm[..., 1, 0] = 1.0                   # all weight on kernel 1
    return {"poses_3d": data.poses_3d, "poses_2d_gmm": gmm,
            "seeds": np.arange(windows, dtype=np.int32) * 7919 - 5}


@pytest.mark.parametrize("test_times", [1, 2])
def test_eval_step_matches_jax(test_times):
    """Every eval forward (module, row 3 with torch or kernel temporal
    blocks, row 9) against the JAX step, one-component GMM."""
    jm, params, tm = video_pair(15)
    batch = one_component_windows(tm.frames)
    j_step = jax.jit(j_make_eval_step(jm, BETAS, SEQ, test_times=test_times,
                                      mask=jnp.ones((1, 1, 17))))
    want = j_step(JTrainState.create(params, opt_state=(), ema_params=None),
                  {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    state = TrainState.create(tm, None)
    for override in (None, make_video_denoiser_fn(tm),
                     make_video_denoiser_fn(tm, temporal_impl="kernel"), fv.make_video_full_fn(tm)):
        step = make_video_eval_step(tm, BETAS, SEQ, test_times=test_times, device="cpu",
                                    mask=torch.ones(1, 1, 17), denoise_override=override)
        got = step(state, batch, prepared=step.prepare(state))
        for g, w, name in zip(got, want, ("p1", "p2", "pred_xyz")):
            assert tuple(g.shape) == tuple(w.shape), name
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4, err_msg=name)


def test_mesh_axes_raise():
    _, _, tm = video_pair(16)
    with pytest.raises(NotImplementedError, match="item 12"):
        make_video_eval_step(tm, BETAS, SEQ, cp_axis="context", device="cpu")
    opt = optim.make_optimizer(tm.parameters(), lr=1e-3)
    with pytest.raises(NotImplementedError, match="item 12"):
        make_video_train_step(tm, opt, BETAS, data_axis="data", device="cpu")
