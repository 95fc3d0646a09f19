"""Port make_eval_step vs diffpose_tpu.train.steps.make_eval_step.

The two packages draw the GMM kernel from different generators, so the GMM
puts its whole weight on one component: both then pick the same kernel."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffpose_tpu.train.state import TrainState as JTrainState
from diffpose_tpu.train.steps import make_eval_step as j_make_eval_step
from diffpose_tpu_torch.data.synthetic import make_synthetic_dataset
from diffpose_tpu_torch.diffusion import get_beta_schedule
from diffpose_tpu_torch.models.ema import ema_register
from diffpose_tpu_torch.ops.fused_denoiser import fused_denoiser, fused_lifter
from diffpose_tpu_torch.train.state import TrainState
from diffpose_tpu_torch.train.steps import make_eval_step
from test_torch_models import CONFIGS, flax_pair

# Small tensors on a host that runs several test workers: one thread each is
# faster than contended thread pools.
torch.set_num_threads(1)

CFG = CONFIGS[0]
BETAS = get_beta_schedule("linear", beta_start=1e-4, beta_end=1e-3, num_diffusion_timesteps=51)
SEQ = (0, 12)
B = 12


def one_component_batch():
    data = make_synthetic_dataset(num_frames=B, seed=3)
    gmm = data.poses_2d_gmm.copy()
    gmm[..., 0] = 0.0
    gmm[..., 2, 0] = 1.0                   # all weight on kernel 2
    return {"poses_3d": data.poses_3d, "poses_2d_gmm": gmm,
            "seeds": np.arange(B, dtype=np.int32) * 7919 - 5}


@pytest.fixture(scope="module")
def models():
    jd, pd, td = flax_pair(CFG, 0, with_temb=True)
    jp, pp, tp = flax_pair(CFG, 1, with_temb=False)
    return jd, pd, td, jp, pp, tp


@pytest.mark.parametrize("test_times", [1, 3])
def test_eval_step_matches_jax(models, test_times):
    jd, pd, td, jp, pp, tp = models
    batch = one_component_batch()
    j_step = jax.jit(j_make_eval_step(jd, jp, BETAS, SEQ, test_times=test_times,
                                      mask=jnp.ones((1, 1, 17))))
    jstate = JTrainState.create(pd, opt_state=(), ema_params=None)
    want = j_step(jstate, pp, {k: jnp.asarray(v) for k, v in batch.items()}, jax.random.PRNGKey(0))
    state = TrainState.create(td, None)
    for impl in ("module", "fused"):
        step = make_eval_step(td, tp, BETAS, SEQ, test_times=test_times, impl=impl, device="cpu")
        got = step(state, tp, batch)
        for g, w, name in zip(got, want, ("p1", "p2", "pred_xyz")):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-4, err_msg=f"{impl} {name}")
        assert got[0].shape == (B,) and got[2].shape == (B, 17, 3)


def test_fused_on_cpu_equals_module_and_launches_nothing(models):
    _, _, td, _, _, tp = models
    batch = one_component_batch()
    state = TrainState.create(td, None)
    fused = make_eval_step(td, tp, BETAS, SEQ, test_times=2, impl="fused", device="cpu")
    module = make_eval_step(td, tp, BETAS, SEQ, test_times=2, impl="module", device="cpu")
    fused_lifter.launches = fused_denoiser.launches = 0
    a = fused(state, tp, batch, prepared=fused.prepare(state, tp))
    b = module(state, None, batch)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=5e-5)
    assert (fused_lifter.launches, fused_denoiser.launches) == (0, 0)
    assert module.prepare(state, tp) is None
    with pytest.raises(ValueError, match="impl must be"):
        make_eval_step(td, tp, BETAS, SEQ, impl="pallas", device="cpu")


@pytest.mark.parametrize("impl", ["module", "fused"])
def test_use_ema_evaluates_the_shadow_and_restores_the_live_weights(models, impl):
    _, _, td, _, _, tp = models
    batch = one_component_batch()
    shadow = ema_register(td)
    with torch.no_grad():
        for v in shadow.values():
            v.mul_(0.9)
    live = {k: v.detach().clone() for k, v in td.named_parameters()}
    state = TrainState.create(td, None, shadow)
    plain = make_eval_step(td, tp, BETAS, SEQ, impl=impl, device="cpu")(state, tp, batch)
    ema = make_eval_step(td, tp, BETAS, SEQ, impl=impl, use_ema=True, device="cpu")(state, tp, batch)
    assert float((plain[2] - ema[2]).abs().max()) > 1e-4
    assert all(torch.equal(live[k], v) for k, v in td.named_parameters())
    # the shadow's values as live weights give the same answer
    import copy

    td2 = copy.deepcopy(td)
    td2.load_state_dict({**td2.state_dict(), **shadow})
    want = make_eval_step(td2, tp, BETAS, SEQ, impl=impl, device="cpu")(
        TrainState.create(td2, None), tp, batch)
    np.testing.assert_allclose(ema[2].numpy(), want[2].numpy(), atol=1e-6)


def test_start_noise_and_eta_use_the_generator(models):
    _, _, td, _, _, tp = models
    batch = one_component_batch()
    state = TrainState.create(td, None)
    step = make_eval_step(td, tp, BETAS, SEQ, add_start_noise=True, eta=0.5, device="cpu")
    a = step(state, tp, batch, torch.Generator().manual_seed(1))
    b = step(state, tp, batch, torch.Generator().manual_seed(1))
    c = step(state, tp, batch, torch.Generator().manual_seed(2))
    assert torch.equal(a[2], b[2]) and not torch.equal(a[2], c[2])
    assert bool(torch.isfinite(a[0]).all()) and bool(torch.isfinite(a[1]).all())
