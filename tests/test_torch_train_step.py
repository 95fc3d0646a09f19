"""Port train step (optimizer, clip, EMA, train state, sweep, checkpoint) vs
optax + ema_update on the JAX side, the random draws handed to both."""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from diffpose_tpu.models.ema import ema_update as j_ema_update
from diffpose_tpu.ops import train_ref as jref
from diffpose_tpu.train import optim as joptim
from diffpose_tpu_torch.data.synthetic import make_synthetic_dataset
from diffpose_tpu_torch.diffusion import get_beta_schedule
from diffpose_tpu_torch.models import convert
from diffpose_tpu_torch.models.ema import ema_register
from diffpose_tpu_torch.ops import fused_train as ft
from diffpose_tpu_torch.train import optim
from diffpose_tpu_torch.train.checkpoint import load_train_state, save_train_state
from diffpose_tpu_torch.train.state import TrainState
from diffpose_tpu_torch.train.steps import (
    diffusion_loss,
    make_train_step,
    make_train_sweep_step,
)
from test_torch_models import BASIS, CONFIGS, flax_pair

CFG = CONFIGS[0]
BETAS = get_beta_schedule("linear", beta_start=1e-4, beta_end=1e-3, num_diffusion_timesteps=51)
DATA = make_synthetic_dataset(num_frames=64, seed=0)
B = 8


def batch_of(i):
    sl = slice(i * B, (i + 1) * B)
    return {"poses_3d": DATA.poses_3d[sl], "poses_2d_gmm": DATA.poses_2d_gmm[sl]}


def port_state(tm, impl="plain", **opt_kwargs):
    model = copy.deepcopy(tm)
    opt = optim.make_optimizer(model.parameters(), **opt_kwargs)
    state = TrainState.create(model, opt, ema_register(model))
    return state, make_train_step(model, opt, BETAS, impl=impl, device="cpu")


def jax_draws(d):
    """The port's draws as JAX arrays, masks in the JAX package's joint-major layout."""
    m = d.masks
    masks = jref.DropoutMasks(
        probs=jnp.asarray(m.probs.permute(0, 3, 4, 1, 2).float().numpy()),
        **{k: jnp.asarray(getattr(m, k).permute(0, 2, 1, 3).float().numpy())
           for k in ("attn_out", "gnet_out", "cheb1", "cheb2")})
    return (jnp.asarray(d.x_t.numpy()), jnp.asarray(d.t.numpy().astype(np.float32)),
            jnp.asarray(d.e.numpy()), masks)


def make_jax_step(optimizer):
    @jax.jit
    def step(params, opt_state, ema, x_t, t, e, masks):
        def loss_fn(p):
            out = jref.train_forward(p, BASIS, x_t, t, masks, **CFG)
            return jnp.mean(jnp.sum((e - out) ** 2, axis=(1, 2)))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = optimizer.update(grads, opt_state, params)
        params = optax.apply_updates(params, updates)
        return (params, opt_state, j_ema_update(ema, params, 0.999), loss,
                optax.global_norm(grads))

    return step


def assert_params_close(model_or_dict, want_tree, atol=1e-6):
    sd = model_or_dict if isinstance(model_or_dict, dict) else dict(model_or_dict.named_parameters())
    got = convert.flax_from_state_dict(sd, with_temb=True, num_layers=CFG["num_layers"])
    flat_w, _ = jax.tree_util.tree_flatten_with_path(want_tree)
    flat_g, _ = jax.tree_util.tree_flatten_with_path(got)
    assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
    for (path, want), (_, have) in zip(flat_w, flat_g):
        np.testing.assert_allclose(np.asarray(have), np.asarray(want), rtol=0, atol=atol,
                                   err_msg=jax.tree_util.keystr(path))


# End to end (each side computes its own gradients) Adam runs with this eps.
# With the config's 1e-8, Adam divides an entry's gradient by its own size:
# where that is rounding noise (the key bias, whose gradient is
# mathematically 0; weights behind dead units) the two frameworks' steps
# differ by up to the full rate whatever the code does.  The config's eps is
# held to optax with the gradients given, in tests/test_torch_optim.py.
E2E_EPS = 1e-4


def run_both(rng_seed, n_steps, impl="plain", **opt_kwargs):
    _, params, tm = flax_pair(CFG, rng_seed, with_temb=True)
    state, step = port_state(tm, impl, **opt_kwargs)
    joptimizer = joptim.make_optimizer(**opt_kwargs)
    jstep = make_jax_step(joptimizer)
    jparams, jopt, jema = params, joptimizer.init(params), params
    gen = torch.Generator().manual_seed(rng_seed)
    for i in range(n_steps):
        d = step.draw(batch_of(i), gen)
        state, metrics = step.apply(state, d)
        jparams, jopt, jema, jloss, jnorm = jstep(jparams, jopt, jema, *jax_draws(d))
        np.testing.assert_allclose(float(metrics["loss"]), float(jloss), rtol=1e-5)
        np.testing.assert_allclose(float(metrics["grad_norm"]), float(jnorm), rtol=1e-4)
    return state, jparams, jema, float(jnorm)


@pytest.mark.parametrize("grad_clip", [1.0, 1e9], ids=["clip_active", "clip_inactive"])
def test_one_adam_step_matches_optax(grad_clip):
    state, jparams, jema, norm = run_both(0, 1, lr=2e-5, grad_clip=grad_clip, eps=E2E_EPS)
    assert norm > 1.0  # the clip at 1.0 bites, the one at 1e9 does not
    assert_params_close(state.model, jparams)
    assert_params_close(state.ema_params, jema)
    assert state.step == 1 and state.optimizer.count == 1


@pytest.mark.parametrize("impl", ["plain", "fused"])
def test_three_steps_across_an_epoch_boundary_match_optax(impl):
    """steps_per_epoch=2, decay every epoch: the third step runs at lr·γ."""
    kw = dict(lr=2e-5, lr_gamma=0.5, decay_epochs=1, steps_per_epoch=2, eps=E2E_EPS)
    state, jparams, jema, _ = run_both(1, 3, impl=impl, **kw)
    assert_params_close(state.model, jparams)
    assert_params_close(state.ema_params, jema)
    assert state.step == 3
    assert state.optimizer.inner.param_groups[0]["lr"] == pytest.approx(1e-5)


@pytest.mark.parametrize("name", ["SGD", "RMSProp"])
def test_one_sgd_and_rmsprop_step_match_optax(name):
    state, jparams, _, _ = run_both(2, 1, optimizer=name, lr=1e-4)
    assert_params_close(state.model, jparams)


def test_fused_step_equals_plain_step_and_module_step_runs():
    _, _, tm = flax_pair(CFG, 4, with_temb=True)
    (sf, stepf), (sp, stepp), (sm, stepm) = (port_state(tm, impl) for impl in
                                             ("fused", "plain", "module"))
    gen = torch.Generator().manual_seed(4)
    for i in range(2):
        d = stepf.draw(batch_of(i), gen)
        assert d.masks.probs.dtype == torch.uint8 and d.t.dtype == torch.int64
        sf, mf = stepf.apply(sf, d)
        sp, mp = stepp.apply(sp, d)
        np.testing.assert_allclose(float(mf["loss"]), float(mp["loss"]), rtol=1e-6)
    for a, b in zip(sf.model.parameters(), sp.model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(), atol=2e-6)
    sm, mm = stepm(sm, batch_of(0), gen)
    assert np.isfinite(float(mm["loss"])) and sm.step == 1
    assert stepm.draw(batch_of(0), gen).masks is None
    moved = max(float((a.detach() - b.detach()).abs().max())
                for a, b in zip(sm.model.parameters(), tm.parameters()))
    assert moved > 0
    eps, e = torch.zeros(2, 17, 5), torch.ones(2, 17, 5)
    assert float(diffusion_loss(eps, e)) == 85.0  # sum over joints and coordinates, batch mean


def test_sweep_equals_single_steps():
    _, _, tm = flax_pair(CFG, 5, with_temb=True)
    (sa, stepa), (sb, stepb) = port_state(tm, "fused"), port_state(tm, "fused")
    sweep = make_train_sweep_step(sa.model, sa.optimizer, BETAS, sweep=3, device="cpu",
                                  base_step=stepa)
    data = {"poses_3d": torch.as_tensor(DATA.poses_3d),
            "poses_2d_gmm": torch.as_tensor(DATA.poses_2d_gmm)}
    idx = torch.as_tensor(np.random.default_rng(5).permutation(64)[:3 * B].reshape(3, B))
    sa, out = sweep(sa, data, idx, torch.Generator().manual_seed(9))
    gen, singles = torch.Generator().manual_seed(9), []
    for ids in idx:
        sb, m = stepb(sb, {k: v[ids] for k, v in data.items()}, gen)
        singles.append(m["loss"])
    assert out["loss"].shape == (3,) and torch.equal(out["loss"], torch.stack(singles))
    assert sa.step == sb.step == 3
    for a, b in zip(sa.model.parameters(), sb.model.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="built for 3"):
        sweep(sa, data, idx[:2], gen)


def test_train_state_checkpoint_roundtrip(tmp_path):
    _, _, tm = flax_pair(CFG, 6, with_temb=True)
    state, step = port_state(tm, "fused", lr=1e-3)
    gen = torch.Generator().manual_seed(6)
    for i in range(2):
        state, _ = step(state, batch_of(i), gen)
    state.epoch = 3
    path = str(tmp_path / "ckpt.pth")
    save_train_state(path, state)

    fresh, fstep = port_state(tm, "fused", lr=1e-3)
    assert load_train_state(path, fresh) is fresh
    assert (fresh.step, fresh.epoch, fresh.optimizer.count) == (2, 3, 2)
    for (k, a), b in zip(state.model.named_parameters(), fresh.model.parameters()):
        assert torch.equal(a, b), k
        assert torch.equal(state.ema_params[k], fresh.ema_params[k]), k
    # the optimizer's moments came along: the next step is the same step
    d = step.draw(batch_of(2), gen)
    state, m1 = step.apply(state, d)
    fresh, m2 = fstep.apply(fresh, d)
    assert torch.equal(m1["loss"], m2["loss"])
    for a, b in zip(state.model.parameters(), fresh.model.parameters()):
        assert torch.equal(a, b)


def test_step_refuses_a_missing_card_and_a_foreign_state(monkeypatch):
    _, _, tm = flax_pair(CFG, 7, with_temb=True)
    state, step = port_state(tm)
    other, _ = port_state(tm)
    with pytest.raises(ValueError, match="another model"):
        step.apply(other, step.draw(batch_of(0), torch.Generator().manual_seed(0)))
    with pytest.raises(ValueError, match="impl must be"):
        make_train_step(state.model, state.optimizer, BETAS, impl="xla", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(state.model, state.optimizer, BETAS)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ft.make_train_step(state.model, state.optimizer, BETAS)
