"""Port optimizer assembly and EMA vs optax and the JAX package, the
gradients handed to both sides."""

import copy

import numpy as np
import optax
import pytest
import torch

from diffpose_tpu.train import optim as joptim
from diffpose_tpu_torch.models import convert
from diffpose_tpu_torch.models.ema import ema_register, ema_update
from diffpose_tpu_torch.train import optim
from test_torch_models import CONFIGS, flax_pair
from test_torch_train_step import assert_params_close

CFG = CONFIGS[0]


@pytest.mark.parametrize("name", ["Adam", "SGD", "RMSProp"])
def test_optimizers_match_optax_given_the_gradients(rng, name):
    """Three updates with the same gradients on both sides, at the config's
    eps, the clip biting on the first only, the staircase stepping down at
    the third."""
    _, params, tm = flax_pair(CFG, 0, with_temb=True)
    kw = dict(optimizer=name, lr=2e-5, lr_gamma=0.5, decay_epochs=1, steps_per_epoch=2)
    model = copy.deepcopy(tm)
    opt = optim.make_optimizer(model.parameters(), **kw)
    joptimizer = joptim.make_optimizer(**kw)
    jparams, jstate = params, joptimizer.init(params)
    names = [n for n, _ in model.named_parameters()]
    for scale in (3.0, 1e-3, 1e-3):
        grads = {n: (scale * rng.normal(size=p.shape)).astype(np.float32)
                 for n, p in model.named_parameters()}
        jgrads = convert.flax_from_state_dict(grads, with_temb=True, num_layers=CFG["num_layers"])
        for n, p in zip(names, model.parameters()):
            p.grad = torch.as_tensor(grads[n].copy())
        norm = float(opt.step())
        np.testing.assert_allclose(norm, float(optax.global_norm(jgrads)), rtol=1e-6)
        assert (norm > 1.0) == (scale == 3.0)
        updates, jstate = joptimizer.update(jgrads, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        assert_params_close(model, jparams, atol=1e-7)
    assert opt.count == 3 and opt.inner.param_groups[0]["lr"] == pytest.approx(1e-5)


def test_staircase_lr_matches_the_jax_schedule():
    ours = optim.staircase_lr(2e-5, 0.9, 60, 7)
    theirs = joptim.staircase_lr(2e-5, 0.9, 60, 7)
    for step in (0, 6, 7, 419, 420, 421, 60 * 7 * 3 + 1):
        assert ours(step) == pytest.approx(float(theirs(step)), rel=1e-12)
    with pytest.raises(NotImplementedError):
        optim.make_optimizer([torch.nn.Parameter(torch.zeros(1))], optimizer="Adagrad")


def test_clip_is_optax_not_torch():
    """scale = clip / max(norm, clip): gradients under the clip pass unchanged."""
    p = torch.nn.Parameter(torch.zeros(4))
    opt = optim.make_optimizer([p], optimizer="SGD", lr=1.0, grad_clip=1.0)
    p.grad = torch.tensor([0.3, 0.0, 0.4, 0.0])
    assert float(opt.step()) == pytest.approx(0.5)
    np.testing.assert_array_equal(p.detach().numpy(), -np.array([0.3, 0.0, 0.4, 0.0], np.float32))
    p.grad = torch.tensor([3.0, 0.0, 4.0, 0.0])
    assert float(opt.step()) == pytest.approx(5.0)  # the norm before the clip
    np.testing.assert_allclose(p.grad.numpy(), [0.6, 0.0, 0.8, 0.0], rtol=1e-6)


def test_ema_is_a_copy_and_updates_in_place():
    _, _, tm = flax_pair(CFG, 3, with_temb=True)
    shadow = ema_register(tm)
    first = next(iter(shadow))
    assert shadow[first].data_ptr() != dict(tm.named_parameters())[first].data_ptr()
    before = {k: v.clone() for k, v in shadow.items()}
    with torch.no_grad():
        for p in tm.parameters():
            p.add_(1.0)
    assert ema_update(shadow, tm, 0.9) is shadow
    for k, p in tm.named_parameters():
        torch.testing.assert_close(shadow[k], 0.1 * p.detach() + 0.9 * before[k])


