"""Kernel row 4's plain twin vs the JAX Pallas ChebConv (interpret mode) and
vs the port's ChebGraphConv; the GraFormer eval forward over it; the CUDA
wrapper's refusals.

The CUDA kernel itself runs only on the card; chip_smoke.py holds it against
``cheb_conv_plain`` there.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from diffpose_tpu.ops.pallas_cheb import fused_cheb_conv as pallas_cheb_conv
from diffpose_tpu_torch.models.layers import ChebGraphConv
from diffpose_tpu_torch.ops import fused_cheb as fc
from diffpose_tpu_torch.ops.fused_graformer import make_graformer_fn
from test_torch_graformer import GRAPHS, graformer_pair, two_joints_masked

BASIS21 = GRAPHS[21]


def test_cheb_conv_plain_matches_pallas_interpret(rng):
    x = rng.normal(size=(8, 21, 8)).astype(np.float32)
    w = (0.2 * rng.normal(size=(3, 8, 8))).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    want = np.asarray(pallas_cheb_conv(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), BASIS21,
                                       block_b=8, interpret=True))
    got = fc.cheb_conv_plain(torch.as_tensor(x), torch.as_tensor(w), torch.as_tensor(b),
                             torch.as_tensor(BASIS21)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


@pytest.mark.parametrize("c_in,c_out", [(2, 8), (8, 8), (8, 3)])
def test_fused_cheb_conv_cpu_matches_module(rng, c_in, c_out):
    torch.manual_seed(c_in * 10 + c_out)
    conv = ChebGraphConv(c_in, c_out, BASIS21)
    with torch.no_grad():
        conv.bias.normal_()
    x = torch.as_tensor(rng.normal(size=(5, 21, c_in)).astype(np.float32))  # 5: any tile is ragged
    before = fc.fused_cheb_conv.launches
    with torch.no_grad():
        got = fc.fused_cheb_conv(x, conv.weight[:, 0], conv.bias.reshape(-1), BASIS21)
        made_once = fc.fused_cheb_conv(x, conv.weight[:, 0], conv.bias.reshape(-1),
                                       fc.graph_constants(BASIS21, "cpu"))
        want = conv(x)
    assert fc.fused_cheb_conv.launches == before
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-5)
    np.testing.assert_array_equal(made_once.numpy(), got.numpy())


@pytest.mark.parametrize("masked", [False, True], ids=["nomask", "mask"])
def test_make_graformer_fn_cpu_matches_module(rng, masked):
    _, _, tm = graformer_pair(21, 8)
    x = torch.as_tensor(rng.normal(size=(6, 21, 2)).astype(np.float32))
    mask = torch.as_tensor(two_joints_masked(6, 21)) if masked else None
    fn = make_graformer_fn(tm)
    with torch.no_grad():
        want = tm(x, mask)
    np.testing.assert_allclose(fn(x, mask).numpy(), want.numpy(), atol=5e-5)
    tm.train()
    with pytest.raises(ValueError, match="eval"):
        fn(x, mask)


def test_term_list_is_ordered_by_order_within_each_joint():
    """The kernel walks a joint's terms once, order by order, and T_0 = I is in it."""
    g = fc.graph_constants(BASIS21, "cpu")
    ptr, idx = g["cheb_ptr"].numpy(), g["cheb_idx"].numpy()
    assert ptr[0] == 0 and ptr[-1] == len(idx) and len(ptr) == 22
    for n in range(21):
        orders = idx[ptr[n]:ptr[n + 1]] >> 8
        assert (np.diff(orders) >= 0).all() and set(orders) == {0, 1, 2}
        assert (idx[ptr[n]:ptr[n + 1]][orders == 0] & 0xFF).tolist() == [n]


def test_launch_refuses_what_the_kernel_does_not_take():
    g = fc.graph_constants(BASIS21, "cpu")
    x, w, b = torch.zeros(2, 21, 4), torch.zeros(3, 4, 4), torch.zeros(4)
    with pytest.raises(ValueError, match="CUDA tensors"):
        fc._launch(x, w, b, g)
    wide = fc.graph_constants(np.eye(33, dtype=np.float32)[None].repeat(3, 0), "cpu")
    with pytest.raises(ValueError, match="at most 32 joints"):
        fc._launch(torch.zeros(2, 33, 4), w, b, wide)
