"""The reduced kernel tiers (``--kernel_precision bf16`` and ``default``) of
the train kernels, rows 5-8, on the CPU, where the wrappers run their plain
tier versions (``ops/train_ref.py:layers_forward``,
``ops/fused_train.py:stack_bwd_plain`` at ``tier=``).

* bf16: the plain stack rounds where ``diffpose_tpu/ops/pallas_train.py``
  rounds at ``precision="bf16"`` (both operands of every channel product,
  and the attention's segment products), and takes its order of the fc2 mix
  and product.  It is held to the Pallas kernel pair in interpret mode on
  the same masks: the forward within TOL_FWD of each output's largest entry,
  the data gradients and the weight gradients within TOL_BWD (the JAX masks
  pair recomputes ``hc`` for the Chebyshev weights' gradients in float32
  where the port stashes the kernel's; on these seeds that is the largest
  difference, 1.2e-3 of wg1's scale).
* default (one TF32 pass): the plain products within TOL_DEFAULT_MODEL of the
  same stack on ``ops/tf32.py:matmul_1xtf32`` (the card's mma.sync), and the
  forward within TOL_DEFAULT of JAX at ``precision=None``, which the CPU
  computes in float32.
* the steps: one fused step at bf16 equals one plain step at bf16 in each
  family; the video family trains its kernels at the parity grade under
  ``default``, as ``diffpose_tpu/train/video_runner.py:229`` does.

One Pallas interpret-mode call per tier (a forward and its VJP), at hid 32,
4 heads, one layer, B=8, on the six-joint graph of
``tests/test_torch_precision.py``.
"""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpose_tpu.ops import train_ref as jref
from diffpose_tpu.ops.pallas_denoiser import _prep_weights
from diffpose_tpu.ops.pallas_train import STACK_KEYS, build_pallas_train_stack, kernel_masks
from diffpose_tpu_torch.config import load_config
from diffpose_tpu_torch.data.synthetic import make_synthetic_dataset
from diffpose_tpu_torch.data.video import synthetic_video_dataset
from diffpose_tpu_torch.diffusion import get_beta_schedule
from diffpose_tpu_torch.models import IGCN, GCNDiff
from diffpose_tpu_torch.models.ema import ema_register
from diffpose_tpu_torch.ops import fused_train as ft
from diffpose_tpu_torch.ops.fused_denoiser import _cheb, prepare_weights
from diffpose_tpu_torch.ops.tf32 import matmul_1xtf32, matmul_bf16
from diffpose_tpu_torch.ops.fused_igcn_train import make_igcn_train_fn
from diffpose_tpu_torch.ops.train_ref import layers_forward, make_dropout_masks
from diffpose_tpu_torch.train import optim
from diffpose_tpu_torch.train.state import TrainState
from diffpose_tpu_torch.train.steps import make_train_step
from diffpose_tpu_torch.train.trainer import DiffposeRunner
from diffpose_tpu_torch.train.implicit_runner import ImplicitRunner
from diffpose_tpu_torch.train.video_runner import VideoRunner
from diffpose_tpu_torch.train.video_steps import make_video_train_step
from test_torch_models import BASIS, CONFIGS
from test_torch_precision import GRAPH, JOINTS, small_pair
from test_torch_train_ref import jax_masks, to_port_masks
from test_torch_video_models import video_pair

torch.set_num_threads(1)

TOL_FWD = 1e-3            # of max|out|: the bf16 forward against the Pallas kernel
TOL_BWD = 5e-3            # of max|out|: the bf16 data and weight gradients
TOL_DEFAULT_MODEL = 1e-3  # the plain TF32 products against the mma.sync model
TOL_DEFAULT = 2e-3        # of max|out|: one TF32 pass against float32
FLOOR = 0.25              # the port's bf16-to-f32 distance against JAX's, at least
L, H, HEADS, B = 1, 32, 4, 8
FWD_STASHES = ("ha", "hb", "y1", "att", "r1", "rc1", "rd1")   # the JAX masks pair's
BETAS = get_beta_schedule("linear", beta_start=1e-4, beta_end=1e-3, num_diffusion_timesteps=51)


def _rel(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


def _close(got, want, tol, what=""):
    err = _rel(got, want)
    assert err <= tol, f"{what}: max|Δ| {err:.3e} of the output's scale, bound {tol}"
    return err


@pytest.fixture(scope="module")
def case():
    """Weights (a GCNDiff layer on six joints), inputs and masks, and the
    Pallas kernel pair's forward, stashes and VJP at bf16 and at None."""
    _, params, tm = small_pair(0, True)
    rng = np.random.default_rng(0)

    def bern(rate, shape):
        return (rng.random(shape) < 1.0 - rate).astype(np.float32)

    n = JOINTS
    m = jref.DropoutMasks(probs=bern(0.1, (L, n, n, B, HEADS)), attn_out=bern(0.25, (L, n, B, H)),
                          gnet_out=bern(0.25, (L, n, B, H)), cheb1=bern(0.1, (L, n, B, H)),
                          cheb2=bern(0.1, (L, n, B, H)))
    h0 = rng.normal(size=(B, n, H)).astype(np.float32)
    tp = rng.normal(size=(L, B, H)).astype(np.float32)
    dd5 = rng.normal(size=(B, n, H)).astype(np.float32)
    jw, _, _, _ = _prep_weights(params, GRAPH, L, HEADS, H)
    jstack = {k: jw[k] for k in STACK_KEYS}
    km = kernel_masks(jax_masks(m), H // HEADS)
    jax_out = {}
    for prec in ("bf16", None):
        stack = build_pallas_train_stack(GRAPH, block_b_fwd=B, block_b_bwd=B, group=n,
                                         precision=prec, interpret=True, num_layers=L,
                                         num_heads=HEADS, hid_dim=H)
        args = (jnp.asarray(h0.transpose(1, 0, 2)), jnp.asarray(tp))
        d5, vjp = jax.vjp(lambda w, a, b: stack(w, a, b, km), jstack, *args)
        dw, da0, dtp = vjp(jnp.asarray(dd5.transpose(1, 0, 2)))
        jax_out[prec] = dict(d5=np.asarray(d5).transpose(1, 0, 2),
                             da0=np.asarray(da0).transpose(1, 0, 2), dtp=np.asarray(dtp),
                             dw={k: np.asarray(v) for k, v in dw.items()})
        if prec == "bf16":   # the stashes, from the forward kernel alone
            st = stack.run_fwd(jstack, *args, km)[1]
            jax_out[prec]["st"] = {k: np.asarray(st[k]).transpose(0, 2, 1, 3)
                                   for k in FWD_STASHES}
    return dict(tm=tm, masks=to_port_masks(m), h0=h0, tp=tp, dd5=dd5, jax=jax_out)


def port_stack(c, tier, matmul=None):
    """The port's plain stack at ``tier`` (the CPU wrappers, or with
    ``matmul`` the same functions on other products): d5, its stashes, the
    data gradients and every weight gradient, in the JAX package's layout."""
    w = prepare_weights(c["tm"], device="cpu")
    h0, tp, dd5 = (torch.as_tensor(c[k]) for k in ("h0", "tp", "dd5"))
    km = ft.kernel_masks(c["masks"])
    with torch.no_grad():
        if matmul is None:
            d5, st = ft.stack_fwd(w, h0, tp, km, tier=tier)
            da0, dtp, ds = ft.stack_bwd(w, km, st, dd5, tier=tier)
        else:
            d5, st = layers_forward(w, h0, tp, c["masks"], return_stashes=True, matmul=matmul,
                                    tier=tier)
            da0, dtp, ds = ft.stack_bwd_plain(w, c["masks"], st, dd5, matmul=matmul, tier=tier)
        dw = ft.weight_grads(w, st, ds)
    for k in ("wg1", "wg2"):     # [L, C, 3·D] -> the JAX package's [L, 3, C, D]
        dw[k] = dw[k].reshape(L, H, 3, H).permute(0, 2, 1, 3)
    return dict(d5=d5.numpy(), st={k: v.numpy() for k, v in st.items()}, da0=da0.numpy(),
                dtp=dtp.numpy(), dw={k: v.numpy() for k, v in dw.items()})


def test_bf16_forward_matches_the_pallas_kernels(case):
    got, want = port_stack(case, "bf16"), case["jax"]["bf16"]
    _close(got["d5"], want["d5"], TOL_FWD, "d5")
    for k in FWD_STASHES:
        _close(got["st"][k], want["st"][k], TOL_FWD, k)


def test_bf16_gradients_match_the_pallas_kernels(case):
    got, want = port_stack(case, "bf16"), case["jax"]["bf16"]
    _close(got["da0"], want["da0"], TOL_BWD, "da0")
    _close(got["dtp"], want["dtp"], TOL_BWD, "dtp")
    for k in STACK_KEYS:
        _close(got["dw"][k], want["dw"][k], TOL_BWD, k)


def test_bf16_stack_rounds(case):
    """The floor: the port's bf16 stack is as far from its float32 stack as
    the Pallas pair's bf16 is from its f32 (at least FLOOR of it), so a tier
    that rounded nothing would fail."""
    got, f32 = port_stack(case, "bf16"), port_stack(case, "bf16x3")
    jb, jf = case["jax"]["bf16"], case["jax"][None]
    for k in ("d5", "da0", "dtp"):
        assert _rel(got[k], f32[k]) >= FLOOR * _rel(jb[k], jf[k]) > 1e-4, k


def test_default_tier_products_are_the_one_pass_mma_model(case):
    got, model = port_stack(case, "default"), port_stack(case, "default", matmul=matmul_1xtf32)
    for k in ("d5", "da0", "dtp"):
        assert float(np.abs(got[k] - model[k]).max()) <= TOL_DEFAULT_MODEL, k


def test_default_tier_is_float32_within_one_tf32_pass(case):
    got, want = port_stack(case, "default"), case["jax"][None]
    assert _close(got["d5"], want["d5"], TOL_DEFAULT, "d5") > 1e-6   # the TF32 rounding did run
    f32 = port_stack(case, "bf16x3")
    _close(f32["d5"], want["d5"], 1e-5, "d5 at the parity grade")


def test_fc2_in_the_parity_kernels_order_misses_the_pallas_kernels(case):
    """The bf16 forward with fc2 as the parity kernel orders it,
    lap·(r1·W_fc2), from the same stashes: the first Chebyshev conv's
    output (the rc1 stash) then misses the Pallas kernel's by more than the
    bound that the TPU kernel's order, (lap·r1)·W_fc2, meets."""
    w = prepare_weights(case["tm"], device="cpu")
    m, tp = case["masks"], torch.as_tensor(case["tp"])
    with torch.no_grad():
        _, st = layers_forward(w, torch.as_tensor(case["h0"]), tp, m, return_stashes=True,
                               tier="bf16")
        f2 = w["lap"][0] @ matmul_bf16(st["r1"][0], w["wfc2"][0]) + w["bfc2"][0]
        hc = st["hb"][0] + f2 * (m.gnet_out[0] / 0.75)
        rc1 = torch.relu(_cheb(hc, w["wg1"][0], w["bg1"][0], w["basis"], matmul_bf16))
    want = case["jax"]["bf16"]["st"]["rc1"][0]
    _close(st["rc1"][0], want, TOL_FWD, "rc1")
    assert _rel(rc1, want) > TOL_FWD


def _step(family, impl, tier):
    """One train step of ``family`` at ``tier`` (``impl`` "fused" or "plain")
    from one seeded model and one draw: its loss and the parameters after
    it.  The implicit family's step core, its train function, runs the plain
    stack as ``build_train_stack(..., plain=True)``."""
    torch.manual_seed(3)
    cfg = CONFIGS[0]
    gen = torch.Generator().manual_seed(5)
    if family == "implicit":
        model = IGCN(BASIS, **cfg, solver="damped", max_iterations=3, min_iterations=3).train()
        x = torch.randn((8, 17, 5), generator=gen)
        t = torch.randint(0, 51, (8,), generator=gen).float()
        masks = make_dropout_masks(gen, num_layers=model.num_layers, n_pts=17, batch=8,
                                   num_heads=model.num_heads, hid_dim=model.hid_dim)
        stack = (ft.build_train_stack(BASIS, **cfg, tier=tier, plain=True)
                 if impl == "plain" else None)
        fn = make_igcn_train_fn(model, dropout="masks", stack=stack, tier=tier)
        loss = fn(x, t, masks)[0].square().sum()
        loss.backward()
        return loss.detach(), [p.grad for p in model.parameters()]
    if family == "video":
        _, _, model = video_pair(3, frames=3, num_layers=1)
        data = synthetic_video_dataset(2, 3, seed=1)
        make = make_video_train_step
    else:
        model = GCNDiff(BASIS, **cfg)
        data = make_synthetic_dataset(num_frames=8, seed=0)
        make = make_train_step
    batch = {"poses_3d": data.poses_3d[:8], "poses_2d_gmm": data.poses_2d_gmm[:8]}
    model = model.train()
    opt = optim.make_optimizer(model.parameters(), lr=1e-3)
    state = TrainState.create(model, opt, ema_register(model))
    step = make(model, opt, BETAS, impl=impl, ema_mu=0.999, device="cpu", tier=tier)
    _, metrics = step(state, batch, gen)
    return metrics["loss"], [p.detach().clone() for p in model.parameters()]


@pytest.mark.parametrize("family", ["frame", "implicit", "video"])
def test_fused_step_equals_plain_step_at_bf16(family):
    loss, params = _step(family, "fused", "bf16")
    plain_loss, plain_params = _step(family, "plain", "bf16")
    assert torch.isfinite(loss) and torch.equal(loss, plain_loss)
    assert all(torch.equal(a, b) for a, b in zip(params, plain_params))
    assert not torch.equal(_step(family, "fused", "bf16x3")[0], loss)    # the tier rounded


def test_video_default_step_is_its_parity_step():
    """main_video at --kernel_precision default trains the spatial kernels at
    the parity grade: one runner step against one at bf16x3, bit for bit."""
    config = load_config("configs/human36m_video.yml")
    config.video.frames, config.video.num_layers, config.training.batch_size = 3, 1, 2
    config.training.n_epochs = 1
    losses = {}
    for tier in ("default", "bf16x3"):
        torch.manual_seed(0)
        runner = VideoRunner(config, device="cpu", kernel_precision=tier, train_impl="fused",
                             seed=3)
        assert runner.train_tier() == "bf16x3"
        runner.create_video_model()
        runner.set_data(synthetic_video_dataset(2, 3, seed=1), synthetic_video_dataset(2, 3, seed=2))
        losses[tier] = runner.train()["loss"]
    assert len(losses["default"]) == 1 and np.isfinite(losses["default"]).all()
    assert losses["default"] == losses["bf16x3"]


def test_the_default_tier_warns_where_the_stack_trains_on_the_kernels(caplog):
    """The frame and implicit families warn at default with the fused (frame:
    or plain) stack; not with the module, and not in the video family, which
    trains its kernels at the parity grade there."""
    frame = load_config("configs/human36m_ipose.yml")
    video = load_config("configs/human36m_video.yml")
    video.video.frames, video.video.num_layers = 5, 1
    cases = ((DiffposeRunner, frame, "fused", "default"), (DiffposeRunner, frame, "plain", "default"),
             (DiffposeRunner, frame, "module", None), (ImplicitRunner, frame, "fused", "default"),
             (ImplicitRunner, frame, "plain", None), (VideoRunner, video, "fused", "bf16x3"),
             (VideoRunner, video, "plain", "bf16x3"))
    from diffpose_tpu_torch.train.trainer import warn_default_tier

    for runner, cfg, impl, train_tier in cases:
        r = runner(cfg, device="cpu", kernel_precision="default", train_impl=impl)
        assert r.train_tier() == train_tier, (runner.__name__, impl)
        caplog.clear()
        with caplog.at_level(logging.WARNING):
            warn_default_tier(r.train_tier())
        assert ("TRAIN kernels" in caplog.text) == (train_tier == "default"), (runner.__name__, impl)


def test_rounded_weights_are_made_once_a_snapshot_and_gradients_reach_float32(case):
    """build_train_stack at a tier rounds the products' weights once for a
    weight snapshot (kept in it), without gradient; the gradients reach the
    float32 stacks."""
    w = prepare_weights(case["tm"], device="cpu", differentiable=True)
    stack = ft.build_train_stack(GRAPH, num_layers=L, num_heads=HEADS, hid_dim=H, tier="bf16")
    h0, tp = torch.as_tensor(case["h0"]), torch.as_tensor(case["tp"])
    w["wqkv"].retain_grad()
    d5 = stack(w, h0, tp, case["masks"])
    rounded = w["rounded_bf16"]
    assert torch.equal(rounded["wqkv"], w["wqkv"].detach().to(torch.bfloat16).float())
    assert torch.equal(rounded["wfc2_t"], rounded["wfc2"].transpose(1, 2))
    assert not rounded["wqkv"].requires_grad
    stack(w, h0, tp, case["masks"])
    assert w["rounded_bf16"] is rounded
    d5.sum().backward()
    assert w["wqkv"].grad is not None and bool(torch.isfinite(w["wqkv"].grad).all())
