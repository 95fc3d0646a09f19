"""Port fused video eval forwards and the plain versions of kernel rows 9 and 10
vs the JAX package (diffpose_tpu/ops/pallas_video.py, ops/pallas_video_full.py),
on the CPU, where the wrappers run the plain versions."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffpose_tpu.ops.pallas_video import _temporal_block
from diffpose_tpu.ops.pallas_video_full import (
    _temporal_weight_stacks,
    make_pallas_temporal_layer_fn,
    make_pallas_video_full_fn,
)
from diffpose_tpu_torch.ops import fused_denoiser as fd
from diffpose_tpu_torch.ops import fused_video_full as fv
from diffpose_tpu_torch.ops.fused_video import make_video_denoiser_fn
from test_torch_video_models import inputs, video_pair

torch.set_num_threads(1)


def jax_rows(params, layer):
    return jax.tree_util.tree_map(jnp.asarray, params[f"temporal_{layer}"])


@pytest.mark.parametrize("frames,chunk", [(5, 0), (9, 4)], ids=["f5", "f9_chunked"])
def test_temporal_layer_plain_matches_the_xla_block(rng, frames, chunk):
    """Row 10's plain version (q pre-scaled) against the JAX package's XLA
    temporal block; with a chunk under the window, the chunked attention."""
    _, params, tm = video_pair(3, frames=frames)
    tw = fv.temporal_weight_stacks(tm, "cpu")
    ht = rng.normal(size=(6, frames, 32)).astype(np.float32)
    for layer in range(tm.num_layers):
        want = _temporal_block(jax_rows(params, layer), jnp.asarray(ht), 4, None, chunk)
        got = fv.temporal_layer_plain(tw, torch.as_tensor(ht), layer, attention_chunk=chunk)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)


def test_temporal_layer_plain_matches_the_pallas_kernel_in_interpret_mode(rng):
    _, params, tm = video_pair(4, frames=4, num_layers=1)
    tw = fv.temporal_weight_stacks(tm, "cpu")
    ht = rng.normal(size=(17, 4, 32)).astype(np.float32)
    pallas = make_pallas_temporal_layer_fn(frames=4, num_heads=4, hid_dim=32, precision=None,
                                           interpret=True)
    want = pallas(_temporal_weight_stacks(params, 1, 4, 32), jnp.asarray(ht), 0)
    fv.fused_temporal_layer.launches = 0
    got = fv.fused_temporal_layer(tw, torch.as_tensor(ht), 0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)
    assert fv.fused_temporal_layer.launches == 0      # CPU tensors: the plain version


def test_video_full_fn_matches_the_pallas_kernel_in_interpret_mode(rng):
    """make_video_full_fn over st_layer_plain (row 9's plain version) against
    make_pallas_video_full_fn in interpret mode (tests/test_pallas_video_full.py:36)."""
    jm, params, tm = video_pair(5, frames=4, num_layers=1)
    x, t = inputs(rng, 1, 4)
    want = make_pallas_video_full_fn(jm, block_b=1, precision=None, interpret=True)(
        params, jnp.asarray(x), jnp.asarray(t))
    fv.fused_st_layer.launches = 0
    got = fv.make_video_full_fn(tm)(fv.prepare_video_weights(tm, "cpu"), torch.as_tensor(x),
                                    torch.as_tensor(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)
    assert fv.fused_st_layer.launches == 0


@pytest.mark.parametrize("impl", ["torch", "kernel", "full"])
def test_video_denoisers_match_the_module(rng, impl):
    """Each fused forward at 3 windows against model.apply
    (tests/test_pallas_video.py:34), and st_layer_plain against the
    composition of its two phases."""
    jm, params, tm = video_pair(6)
    x, t = inputs(rng, 3, tm.frames)
    want = jax.jit(jm.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t))
    fn = (fv.make_video_full_fn(tm) if impl == "full"
          else make_video_denoiser_fn(tm, temporal_impl=impl))
    vw = fv.prepare_video_weights(tm, "cpu")
    fd.fused_backbone.launches = 0
    with torch.no_grad():
        got = fn(vw, torch.as_tensor(x), torch.as_tensor(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5)
    assert fd.fused_backbone.launches == 0
    if impl == "full":
        h = fv.embed(vw, torch.as_tensor(x))
        tp = fv.spatial_projections(vw["spatial"], torch.as_tensor(t), tm.frames)[1]
        hs = fd.backbone_plain(vw["layers"][1], h.reshape(-1, 17, 32), tp).reshape(h.shape)
        want1 = fv.from_rows(fv.temporal_layer_plain(vw["temporal"], fv.to_rows(hs), 1), 3)
        torch.testing.assert_close(fv.st_layer_plain(vw["layers"], vw["temporal"], h, tp, 1),
                                   want1, rtol=0, atol=0)


def test_layer_weights_slice_one_weight_prep():
    """One prepare_weights over every spatial block, sliced per layer: each
    one-layer set holds its layer's stacks (16-byte aligned, as the kernels
    check), none of the network's ends, and passes gradients to its own
    layer's parameters."""
    _, _, tm = video_pair(8, num_layers=2)
    sw = fd.prepare_weights(fv.SpatialBlocks(tm), "cpu", differentiable=True)
    lw = fv.layer_weights(sw)
    assert len(lw) == 2 and all(w["num_layers"] == 1 for w in lw)
    for i, w in enumerate(lw):
        assert not set(w) & {"win", "wout", "t0k", "t1k"}
        for k in fv._LAYER_STACKS:
            assert torch.equal(w[k], sw[k][i:i + 1])
        for k, v in w.items():
            if isinstance(v, torch.Tensor):
                assert v.is_contiguous() and v.data_ptr() % 16 == 0, k
    lw[1]["lap"].sum().backward()
    a_hat = [tm.layer(i)[0].feed_forward.A_hat.grad for i in range(2)]
    assert float(a_hat[0].abs().sum()) == 0.0 and float(a_hat[1].abs().sum()) > 0.0


def test_kernel_wrappers_refuse_what_the_kernels_do_not_take():
    """CPU tensors, hid 32 weights, weights without the products' TF32 parts
    or with a part of the wrong shape, and an absent layer raise before any
    library is loaded (this host builds none)."""
    _, _, tm = video_pair(7)
    vw = fv.prepare_video_weights(tm, "cpu")
    ht = torch.zeros(2, 5, 96)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fv._launch_temporal(vw["temporal"], ht, 0)
    with pytest.raises(ValueError, match="hid/heads"):
        fv._temporal_ptrs(vw["temporal"], 0, torch.device("cpu"))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fv._launch_st(vw["layers"], vw["temporal"], torch.zeros(1, 5, 17, 96),
                      torch.zeros(1, 5, 96), 0)
    with pytest.raises(ValueError, match="temporal_impl"):
        make_video_denoiser_fn(tm, temporal_impl="xla")
    # at the kernels' width: the products' TF32 parts, and only them, in their shape
    _, _, wide = video_pair(7, hid_dim=96, num_layers=1)
    cpu = torch.device("cpu")
    with pytest.raises(ValueError, match="TF32 parts"):
        fv._temporal_ptrs(fv.temporal_weight_stacks(wide, "cpu"), 0, cpu)
    tw = fv.prepare_video_weights(wide, "cpu")["temporal"]
    assert len(fv._temporal_ptrs(tw, 0, cpu)) == len(fv._T_KERNEL)
    with pytest.raises(ValueError, match="twqkv_tf32"):
        fv._temporal_ptrs(dict(tw, twqkv_tf32=tw["twqkv"]), 0, cpu)
    with pytest.raises(ValueError, match="layer 1 of a 1-layer"):
        fv._temporal_ptrs(tw, 1, cpu)
