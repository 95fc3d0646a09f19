"""The video kernels' plain versions with the kernels' own arithmetic.

Kernel rows 9 and 10 (``csrc/video_kernel.cuh``) compute every channel
product of the TemporalBlock through ``csrc/tc_gemm.cuh`` (3xTF32
``mma.sync``, per-k-step partials) and the attention's two products on
``mma.sync`` at 3xTF32, the keys in chunks of ``KERNEL_KEYS`` with an
online softmax.  With ``matmul=ops/tf32.py:matmul_3xtf32`` the plain
versions compute that arithmetic (the attention in the kernels' order,
``window_attention``).  Held here: the TF32 model of row 10 within 5e-5 of
the f32 plain version at the kernel's widths (hid 96, 4 heads) and of the
JAX package's Pallas kernel in interpret mode at the small width the other
interpret-mode tests use (hid 32); the TF32 model of row 9 within the
existing test's tolerance of ``make_pallas_video_full_fn`` in interpret
mode; the padded, masked key tiles giving the unpadded attention; the TF32
parts ``prepare_video_weights`` hands the kernels.  The kernels run only on
the card, where chip_smoke.py holds them against the f32 plain versions.
The TF32 model multiplies term by term in float64, so rows are few.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpose_tpu.ops.pallas_video_full import (
    _temporal_weight_stacks,
    make_pallas_temporal_layer_fn,
    make_pallas_video_full_fn,
)
from diffpose_tpu_torch.ops import fused_video_full as fv
from diffpose_tpu_torch.ops.tf32 import matmul_3xtf32, split_tf32
from test_torch_video_models import inputs, video_pair

torch.set_num_threads(1)

TOL_KERNEL = 5e-5     # chip_smoke.py TOL_KERNEL, tests/test_pallas_denoiser.py


@pytest.mark.parametrize("frames,rows", [(9, 6), (81, 2)], ids=["f9", "f81"])
def test_temporal_tf32_model_is_within_the_kernel_bound_of_f32(rng, frames, rows):
    """Row 10 at the kernel's widths: more than one key chunk at F=81, a
    ragged last key tile at both."""
    _, _, tm = video_pair(11, frames=frames, hid_dim=96, num_layers=1)
    tw = fv.temporal_weight_stacks(tm, "cpu")
    ht = torch.as_tensor(rng.normal(size=(rows, frames, 96)).astype(np.float32))
    with torch.no_grad():
        f32 = fv.temporal_layer_plain(tw, ht, 0)
        got = fv.temporal_layer_plain(tw, ht, 0, matmul=matmul_3xtf32)
    assert float((got - f32).abs().max()) <= TOL_KERNEL
    assert not torch.equal(got, f32)          # the TF32 products did run


def test_temporal_tf32_model_matches_the_pallas_kernel_in_interpret_mode(rng):
    _, params, tm = video_pair(4, frames=4, num_layers=1)
    tw = fv.temporal_weight_stacks(tm, "cpu")
    ht = rng.normal(size=(17, 4, 32)).astype(np.float32)
    pallas = make_pallas_temporal_layer_fn(frames=4, num_heads=4, hid_dim=32, precision=None,
                                           interpret=True)
    want = pallas(_temporal_weight_stacks(params, 1, 4, 32), jnp.asarray(ht), 0)
    with torch.no_grad():
        got = fv.temporal_layer_plain(tw, torch.as_tensor(ht), 0, matmul=matmul_3xtf32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_KERNEL)


def test_video_layer_tf32_model_matches_the_pallas_kernel_in_interpret_mode(rng):
    """make_video_full_fn's forward with each layer st_layer_plain at TF32
    (row 9's model) against make_pallas_video_full_fn in interpret mode, at
    tests/test_torch_video_fused.py's tolerance."""
    jm, params, tm = video_pair(5, frames=4, num_layers=1)
    x, t = inputs(rng, 1, 4)
    want = make_pallas_video_full_fn(jm, block_b=1, precision=None, interpret=True)(
        params, jnp.asarray(x), jnp.asarray(t))
    vw = fv.prepare_video_weights(tm, "cpu")
    with torch.no_grad():
        tps = fv.spatial_projections(vw["spatial"], torch.as_tensor(t), 4)
        h = fv.embed(vw, torch.as_tensor(x))
        h = fv.st_layer_plain(vw["layers"], vw["temporal"], h, tps[0], 0, matmul=matmul_3xtf32)
        got = fv.project_out(vw, h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4, rtol=2e-4)


@pytest.mark.parametrize("frames", [1, 33, 81])
def test_padded_masked_key_tiles_give_the_unpadded_attention(rng, frames):
    """window_attention (key chunks of 32, each padded to whole tiles of 8,
    the padded keys masked, an online softmax) is softmax(q kᵀ) v: exactly
    up to rounding in float64, and within the kernel bound at 3xTF32."""
    q, k, v = (torch.as_tensor(rng.normal(size=(2, 4, frames, 24))) for _ in range(3))
    want = torch.softmax(q @ k.transpose(-1, -2), dim=-1) @ v
    torch.testing.assert_close(fv.window_attention(q, k, v), want, rtol=0, atol=1e-12)
    got = fv.window_attention(q.float(), k.float(), v.float(), matmul_3xtf32)
    assert float((got.double() - want).abs().max()) <= TOL_KERNEL


def test_prepared_tf32_parts_are_the_split_of_the_f32_stacks():
    """The kernels' TF32 parts [L, 2, K, N] are split_tf32 of the stacks the
    plain versions read, bit for bit."""
    _, _, tm = video_pair(9, num_layers=2)
    tw = fv.prepare_video_weights(tm, "cpu")["temporal"]
    for key in fv.T_SPLIT_KEYS:
        big, small = split_tf32(tw[key])
        parts = tw[f"{key}_tf32"]
        assert parts.shape == (2, 2, *tw[key].shape[1:]) and parts.is_contiguous()
        assert torch.equal(parts[:, 0], big) and torch.equal(parts[:, 1], small)
    assert not any(k.endswith("_tf32") for k in fv.temporal_weight_stacks(tm, "cpu"))
