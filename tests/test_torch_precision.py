"""The reduced kernel tiers (``--kernel_precision bf16`` and ``default``) of
rows 1-3 and 9-10 on the CPU, where the wrappers run their plain versions.

* bf16: the plain versions round where the CUDA kernels round
  (``csrc/net_kernel.cuh``, ``csrc/video_kernel.cuh``), which is where the TPU
  kernels cast to bf16.  Rows 1-3 are held to the JAX Pallas kernels in
  interpret mode with ``precision="bf16"`` within TOL_BF16 of the output's
  largest entry, far tighter than the 3e-2 relative that
  ``tests/test_pallas_denoiser.py:79`` allows the tier against f32; on these
  seeds they agree to float32 rounding.  Rows 9-10 within TOL_BF16_VIDEO:
  their attention scores sum the products q_d k_d exactly on the tensor
  cores, where the TPU kernel rounds each product to bf16 first (a
  deliberate difference, ROADMAP §3; rows 1-3 do round them).
* default (one TF32 pass): the plain products (operands rounded to TF32,
  float32 sums, ``ops/tf32.py:matmul_tf32``) within TOL_DEFAULT_MODEL of the
  same plain version on ``ops/tf32.py:matmul_1xtf32``, the card's mma.sync
  arithmetic (a TF32 rounding that one float32 ulp flips moves a product by
  2^-11 of it: at two layers such flips reach a few 1e-4); and within
  TOL_DEFAULT of JAX at ``precision=None``, which the CPU computes in float32
  (the Flax forward; the TPU's own single pass cannot be run here).

One Pallas interpret-mode call per kernel, at bf16, at the small width the
other interpret-mode tests use (hid 32, one layer), rows 1-3 on a six-joint
graph (the interpreter's time grows with the joints' unrolled loops); the
GCNDiff's Flax tree is made once for the file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpose_tpu.graph import cheb_basis_from_edges
from diffpose_tpu.models import GCNDiff as JGCNDiff
from diffpose_tpu.models import GCNPose as JGCNPose
from diffpose_tpu.ops.pallas_denoiser import (
    make_pallas_backbone,
    make_pallas_denoiser,
    make_pallas_lifter,
)
from diffpose_tpu.ops.pallas_video_full import (
    _temporal_weight_stacks,
    make_pallas_temporal_layer_fn,
    make_pallas_video_full_fn,
)
from diffpose_tpu_torch.config import load_config
from diffpose_tpu_torch.diffusion import get_beta_schedule
from diffpose_tpu_torch.models import IGCN, GCNDiff, GCNPose, convert
from diffpose_tpu_torch.ops import fused_denoiser as fd
from diffpose_tpu_torch.ops import fused_video_full as fv
from diffpose_tpu_torch.ops.fused_pipeline import make_eval_fn
from diffpose_tpu_torch.ops.tf32 import matmul_1xbf16, matmul_1xtf32, matmul_bf16, round_bf16
from diffpose_tpu_torch.train.implicit_runner import ImplicitRunner
from diffpose_tpu_torch.train.video_runner import VideoRunner
from test_torch_models import BASIS, CONFIGS, perturbed
from test_torch_video_models import inputs, video_pair

torch.set_num_threads(1)

TOL_BF16 = 1e-3          # of max|out|: rows 1-3 bf16 against the Pallas kernels
TOL_BF16_VIDEO = 1e-2    # of max|out|: rows 9-10, the scores' products summed exact
TOL_DEFAULT_MODEL = 1e-3  # the plain TF32 products against the mma.sync model
TOL_DEFAULT = 2e-3       # of max|out|: one TF32 pass against float32
SMALL = dict(CONFIGS[0], num_layers=1)            # hid 32, 4 heads, one layer
JOINTS = 6
GRAPH = cheb_basis_from_edges(JOINTS, [(0, 1), (1, 2), (0, 3), (3, 4), (0, 5)])
NET = dict(hid_dim=96, num_layers=2, num_heads=4)  # the kernels' widths
B = 4


def _close(got, want, tol):
    """max|got - want| within ``tol`` of max|want|; returns the ratio."""
    got, want = np.asarray(got), np.asarray(want)
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert err <= tol, f"max|Δ| {err:.3e} of the output's scale, bound {tol}"
    return err


def small_pair(seed, with_temb):
    """A GCNDiff or GCNPose (hid 32, one layer, six joints) as a Flax tree
    moved off its init, and the port's module on the same weights."""
    cls, tcls, c_in = (JGCNDiff, GCNDiff, 5) if with_temb else (JGCNPose, GCNPose, 2)
    jm = cls(basis=GRAPH, n_pts=JOINTS, **SMALL)
    args = (jnp.zeros((2, JOINTS, c_in)),) + ((jnp.zeros((2,)),) if with_temb else ())
    params = perturbed(jm.init({"params": jax.random.PRNGKey(seed)}, *args)["params"], seed)
    tm = tcls(GRAPH, n_pts=JOINTS, **SMALL)
    tm.load_state_dict(convert.state_dict_from_flax(params, with_temb=with_temb, num_layers=1,
                                                    hid_dim=SMALL["hid_dim"]), strict=True)
    return jm, params, tm.eval()


@pytest.fixture(scope="module")
def gcndiff():
    """small_pair's GCNDiff, with denoiser inputs."""
    jm, params, tm = small_pair(0, True)
    rng = np.random.default_rng(0)
    return (jm, params, tm, rng.normal(size=(B, JOINTS, 5)).astype(np.float32),
            np.array([0.0, 12.0, 12.0, 0.0], np.float32))


def test_bf16_rows_1_and_2_match_the_pallas_kernels(gcndiff):
    _, params, tm, x, t = gcndiff
    want = jax.jit(make_pallas_denoiser(params, GRAPH, block_b=B, interpret=True,
                                        precision="bf16", **SMALL))(jnp.asarray(x), jnp.asarray(t))
    w = fd.tier_weights(fd.prepare_weights(tm, device="cpu"), "bf16")
    with torch.no_grad():
        got = fd.fused_denoiser(w, torch.as_tensor(x), torch.as_tensor(t))
        f32 = fd.fused_denoiser(fd.prepare_weights(tm, device="cpu"), torch.as_tensor(x),
                                torch.as_tensor(t))
    _close(got, want, TOL_BF16)
    assert _close(f32, got, 3e-2) > TOL_BF16          # the tier did round

    _, params, tm = small_pair(1, False)
    x2 = np.random.default_rng(1).normal(size=(B, JOINTS, 2)).astype(np.float32)
    want = jax.jit(make_pallas_lifter(params, GRAPH, block_b=B, interpret=True, precision="bf16",
                                      **SMALL))(jnp.asarray(x2))
    with torch.no_grad():
        got = fd.fused_lifter(fd.prepare_weights(tm, device="cpu"), torch.as_tensor(x2),
                              tier="bf16")
    _close(got, want, TOL_BF16)


def test_bf16_row_3_matches_the_pallas_backbone(gcndiff):
    _, params, tm, _, _ = gcndiff
    rng = np.random.default_rng(2)
    z = rng.normal(size=(B, JOINTS, 32)).astype(np.float32)
    tp = rng.normal(size=(1, B, 32)).astype(np.float32)
    want = jax.jit(make_pallas_backbone(params, GRAPH, block_b=B, interpret=True,
                                        precision="bf16", **SMALL))(jnp.asarray(z), jnp.asarray(tp))
    w = fd.tier_weights(fd.prepare_weights(tm, device="cpu"), "bf16", ends=False)
    assert torch.equal(w["win"], fd.prepare_weights(tm, device="cpu")["win"])   # ends stay f32
    with torch.no_grad():
        got = fd.fused_backbone(w, torch.as_tensor(z), torch.as_tensor(tp))
    _close(got, want, TOL_BF16)
    assert torch.equal(got, round_bf16(got))         # the stream leaves as bf16 values


def test_bf16_rows_9_and_10_match_the_pallas_kernels(rng):
    _, params, tm = video_pair(4, frames=4, num_layers=1)
    ht = rng.normal(size=(17, 4, 32)).astype(np.float32)
    temporal = make_pallas_temporal_layer_fn(frames=4, num_heads=4, hid_dim=32,
                                             precision="bf16", interpret=True)
    want = jax.jit(temporal, static_argnums=2)(_temporal_weight_stacks(params, 1, 4, 32),
                                               jnp.asarray(ht), 0)
    tw = fv.temporal_tier_weights(fv.prepare_video_weights(tm, "cpu")["temporal"], "bf16")
    with torch.no_grad():
        got = fv.fused_temporal_layer(tw, torch.as_tensor(ht), 0)
    _close(got, want, TOL_BF16_VIDEO)

    jm, params, tm = video_pair(5, frames=4, num_layers=1)
    x, t = inputs(rng, 1, 4)
    want = jax.jit(make_pallas_video_full_fn(jm, block_b=1, precision="bf16", interpret=True))(
        params, jnp.asarray(x), jnp.asarray(t))
    vw = fv.prepare_video_weights(tm, "cpu")
    with torch.no_grad():
        got = fv.make_video_full_fn(tm, tier="bf16")(vw, torch.as_tensor(x), torch.as_tensor(t))
    _close(got, want, TOL_BF16_VIDEO)


@pytest.mark.parametrize("row", [1, 3, 10])
def test_default_tier_plain_products_match_the_mma_model(row):
    """At the kernels' widths (hid 96, 4 heads, two layers; row 10 at 33
    frames, two key chunks)."""
    torch.manual_seed(row)
    rng = np.random.default_rng(row)
    with torch.no_grad():
        if row == 10:
            _, _, tm = video_pair(row, frames=33, hid_dim=96, num_layers=1)
            tw = fv.temporal_tier_weights(fv.prepare_video_weights(tm, "cpu")["temporal"],
                                          "default")
            ht = torch.as_tensor(rng.normal(size=(2, 33, 96)).astype(np.float32))
            got = fv.temporal_layer_plain(tw, ht, 0)
            model = fv.temporal_layer_plain(tw, ht, 0, matmul=matmul_1xtf32)
        else:
            tm = (GCNDiff(BASIS, **NET) if row == 1 else IGCN(BASIS, **NET)).eval()
            w = fd.tier_weights(fd.prepare_weights(tm, device="cpu"), "default")
            tp = torch.as_tensor(rng.normal(size=(2, 3, 96)).astype(np.float32))
            x = torch.as_tensor(rng.normal(size=(3, 17, 5 if row == 1 else 96))
                                .astype(np.float32))
            plain = fd.net_plain if row == 1 else fd.backbone_plain
            got, model = plain(w, x, tp), plain(w, x, tp, matmul=matmul_1xtf32)
            assert torch.equal(w["wqkv_1p"], fd.round_weight("default", w["wqkv"]))
    assert float((got - model).abs().max()) <= TOL_DEFAULT_MODEL


def test_bf16_product_is_the_one_pass_mma_model(rng):
    """ops/tf32.py: the bf16 tier's plain product (operands rounded to bf16,
    exact products summed in float32) against the card's one-pass model
    (the same products through K / 8 truncating mma.sync sums): float32
    rounding apart, and both on bf16 operands."""
    a = torch.as_tensor(rng.normal(size=(3, 40, 96)).astype(np.float32))
    w = torch.as_tensor(rng.normal(size=(96, 288)).astype(np.float32))
    got, model = matmul_bf16(a, w), matmul_1xbf16(a, w)
    assert float((got - model).abs().max()) <= 1e-5 * float(model.abs().max())
    assert torch.equal(matmul_bf16(round_bf16(a), w), got)
    assert float((got - a @ w).abs().max()) > 1e-3          # the operands were rounded


def test_default_tier_is_float32_within_one_tf32_pass(gcndiff, rng):
    """Row 1 against the JAX forward at precision=None (float32 on the CPU;
    tests/test_torch_net_tf32.py holds the f32 twins to the Pallas kernel),
    row 10 against its float32 plain version (held to the Pallas kernel by
    tests/test_torch_video_fused.py)."""
    jm, params, tm, x, t = gcndiff
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t))
    with torch.no_grad():
        got = fd.fused_denoiser(fd.prepare_weights(tm, device="cpu"), torch.as_tensor(x),
                                torch.as_tensor(t), tier="default")
    assert _close(got, want, TOL_DEFAULT) > 1e-6          # the TF32 rounding did run

    _, _, tm = video_pair(7, frames=33, hid_dim=96, num_layers=1)
    tw = fv.prepare_video_weights(tm, "cpu")["temporal"]
    ht = torch.as_tensor(rng.normal(size=(2, 33, 96)).astype(np.float32))
    with torch.no_grad():
        assert _close(fv.fused_temporal_layer(tw, ht, 0, tier="default"),
                      fv.temporal_layer_plain(tw, ht, 0), TOL_DEFAULT) > 1e-6


@pytest.mark.parametrize("tier", ["bf16x3", "bf16", "default"])
def test_make_eval_fn_in_each_tier(tier):
    """The main path's inner call on the CPU: finite, and as far from the
    parity pipeline as its tier rounds (bf16 the most)."""
    torch.manual_seed(8)
    pose, diff = GCNPose(BASIS, **CONFIGS[0]).eval(), GCNDiff(BASIS, **CONFIGS[0]).eval()
    wp, wd = fd.prepare_weights(pose, device="cpu"), fd.prepare_weights(diff, device="cpu")
    betas = get_beta_schedule("linear", beta_start=1e-4, beta_end=1e-3, num_diffusion_timesteps=51)
    x2d = torch.randn(6, 17, 2) * 0.3
    kw = dict(seq=(0, 12), betas=betas, test_times=2, device="cpu")
    with torch.no_grad():
        parity = make_eval_fn(BASIS, **kw)(wp, wd, x2d)
        got = make_eval_fn(BASIS, tier=tier, **kw)(fd.tier_weights(wp, tier),
                                                   fd.tier_weights(wd, tier), x2d)
    assert got.shape == (6, 17, 3) and bool(torch.isfinite(got).all())
    err = float((got - parity).abs().max())
    assert {"bf16x3": err == 0, "bf16": 1e-4 < err < 5e-2, "default": 1e-6 < err < 5e-3}[tier]


def test_the_runners_take_every_tier_and_refuse_the_fused_train_stack_at_a_reduced_one():
    """Every tier and matmul grade with every eval forward and, since the
    train kernels have their tiers, with --train_impl fused and plain: the
    name is the one this test had while the train stack refused a reduced
    tier; nothing refuses one now."""
    frame = load_config("configs/human36m_ipose.yml")
    video = load_config("configs/human36m_video.yml")
    video.video.frames, video.video.num_layers, video.training.batch_size = 5, 1, 2
    for tier in ("bf16", "default"):
        for matmul in ("float32", "BF16_BF16_F32_X3", "default"):
            r = ImplicitRunner(frame, device="cpu", kernel_precision=tier, denoiser_impl="fused",
                               eval_matmul_precision=matmul, train_matmul_precision=matmul)
            assert r.kernel_precision == tier
            VideoRunner(video, device="cpu", kernel_precision=tier, denoiser_impl="fused_full",
                        eval_matmul_precision=matmul)
        for runner, cfg in ((ImplicitRunner, frame), (VideoRunner, video)):
            for impl in ("fused", "plain"):
                r = runner(cfg, device="cpu", kernel_precision=tier, train_impl=impl)
                assert r.kernel_precision == tier and r.train_impl == impl


def test_video_runner_evaluates_at_the_bf16_tier():
    """fused_full at bf16 (row 9's plain version on the CPU) against the
    parity eval of the same weights: close, not equal."""
    from diffpose_tpu_torch.data.video import synthetic_video_dataset

    config = load_config("configs/human36m_video.yml")
    config.video.frames, config.video.num_layers, config.training.batch_size = 5, 1, 2
    results = {}
    for tier in ("bf16x3", "bf16"):
        runner = VideoRunner(config, device="cpu", denoiser_impl="fused_full", seed=3,
                             kernel_precision=tier)
        runner.create_video_model()
        runner.set_data(None, synthetic_video_dataset(2, 5, seed=1))
        results[tier] = runner.evaluate(is_train=True)
    (p1, p2), (q1, q2) = results["bf16x3"], results["bf16"]
    assert np.isfinite([q1, q2]).all() and (q1, q2) != (p1, p2)
    assert abs(q1 - p1) < 0.05 * p1
