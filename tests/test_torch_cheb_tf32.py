"""Kernel rows 4 and 12's plain models with the kernels' own arithmetic.

Row 4's wide path (``csrc/cheb_kernel.cuh``, C and D multiples of 8) mixes
the joints first and runs the channel product over ``Z = [T_0·X | T_1·X |
…]`` on the tensor cores at 3xTF32 with a fresh partial sum each k-step of
8, the reduction in slabs of ``KERNEL_KS`` channels, channel chunk outer
and order inner: ``cheb_conv_plain(..., matmul=matmul_3xtf32)``.  Its
narrow paths run f32 FMAs, the proj kernel (D < 8) in the TPU kernel's
order, the product first.  Row 12 (``csrc/probe_attention.cu``) takes the
softmax unnormalised and divides at the end, both products in its mode's
arithmetic: ``batched_dot.attention_model``.  Held here against the f32
plain versions, the JAX package's Pallas ChebConv and the JAX attention
probe in interpret mode.  The kernels run only on the card, where
chip_smoke.py holds them against the f32 plain versions (and row 4's wide
path against this model).  The TF32 models multiply term by term in
float64, so rows are few.
"""

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from diffpose_tpu.ops.pallas_cheb import fused_cheb_conv as pallas_cheb_conv
from diffpose_tpu_torch.ops import fused_cheb as fc
from diffpose_tpu_torch.ops.tf32 import matmul_1xtf32, matmul_3xtf32, mma_chain, round_tf32
from diffpose_tpu_torch.probes import batched_dot as bd
from test_torch_graformer import GRAPHS

torch.set_num_threads(1)

TOL_KERNEL = 5e-5     # chip_smoke.py TOL_KERNEL, tests/test_pallas_denoiser.py
# 1xTF32 rounds both operands to 10 mantissa bits: at F = 81 and standard
# normal inputs the probe's error against f32 is some 5e-3 (PERF.md, row 12);
# held to this, and to more than the 3xTF32 model's.
TOL_1XTF32 = 2e-2


def cheb_inputs(rng, n, bsz, c, d):
    x = torch.as_tensor(rng.normal(size=(bsz, n, c)).astype(np.float32))
    w = torch.as_tensor((rng.normal(size=(3, c, d)) / np.sqrt(3 * c)).astype(np.float32))
    b = torch.as_tensor(rng.normal(size=(d,)).astype(np.float32))
    return x, w, b, torch.as_tensor(GRAPHS[n])


@pytest.mark.parametrize("n,bsz,c,d", [(21, 3, 128, 128), (17, 5, 40, 24)],
                         ids=["21joints-128", "17joints-partial-slab"])
def test_wide_tf32_model_is_within_the_kernel_bound_of_f32(rng, n, bsz, c, d):
    """GraFormer's width at 21 joints, and at 17 joints a width whose last
    slab is partial (40 = 32 + 8 channels) over a batch no tile divides."""
    x, w, b, basis = cheb_inputs(rng, n, bsz, c, d)
    f32 = fc.cheb_conv_plain(x, w, b, basis)
    got = fc.cheb_conv_plain(x, w, b, basis, matmul=matmul_3xtf32)
    assert float((got - f32).abs().max()) <= TOL_KERNEL
    assert not torch.equal(got, f32)          # the TF32 products did run


def test_wide_tf32_model_matches_the_pallas_kernel_in_interpret_mode(rng):
    x, w, b, basis = cheb_inputs(rng, 21, 8, 16, 8)
    want = pallas_cheb_conv(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                            jnp.asarray(b.numpy()), GRAPHS[21], block_b=8, interpret=True)
    got = fc.cheb_conv_plain(x, w, b, basis, matmul=matmul_3xtf32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_KERNEL)


def test_kernel_k_order_walks_channel_chunks_then_orders():
    order = fc.kernel_k_order(3, 40).tolist()
    chunk0 = [k * 40 + c for k in range(3) for c in range(32)]
    chunk1 = [k * 40 + c for k in range(3) for c in range(32, 40)]
    assert order == chunk0 + chunk1
    assert sorted(fc.kernel_k_order(2, 128).tolist()) == list(range(256))


def test_narrow_product_first_order_is_the_plain_convolution(rng):
    """The proj kernel's order (D < 8): P_k = x W_k for every joint, then
    y = Σ_k T_k P_k + b, at 128 → 3 over 17 joints and a ragged batch."""
    x, w, b, basis = cheb_inputs(rng, 17, 7, 128, 3)
    proj = torch.einsum("bmc,kcd->bkmd", x, w)
    got = torch.einsum("knm,bkmd->bnd", basis, proj) + b
    torch.testing.assert_close(got, fc.cheb_conv_plain(x, w, b, basis), rtol=0, atol=TOL_KERNEL)


@pytest.mark.parametrize("mode,frames", [("3xtf32", 81), ("3xtf32", 9), ("1xtf32", 81)])
def test_attention_model_against_f32(rng, mode, frames):
    """Key tiles padded to 8 (81 = 10 tiles + 1 key), the division at the end."""
    q, k, v = (torch.as_tensor(rng.normal(size=(3, frames, 24)).astype(np.float32))
               for _ in range(3))
    want = bd.attention_plain(q, k, v)
    err = float((bd.attention_model(q, k, v, mode) - want).abs().max())
    if mode == "3xtf32":
        assert err <= TOL_KERNEL
    else:
        three = float((bd.attention_model(q, k, v, "3xtf32") - want).abs().max())
        assert three < err <= TOL_1XTF32


def _script(name):
    path = Path(__file__).resolve().parents[1] / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_attention_model_matches_the_jax_probe_in_interpret_mode(rng):
    probe = _script("probe_batched_dot")
    q, k, v = (rng.normal(size=(4, 17, 24)).astype(np.float32) for _ in range(3))
    call = pl.pallas_call(probe.kernel, out_shape=jax.ShapeDtypeStruct((4, 17, 24), jnp.float32),
                          interpret=True)
    want = np.asarray(call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    got = bd.attention_model(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v))
    np.testing.assert_allclose(got.numpy(), want, atol=TOL_KERNEL)


def test_matmul_1xtf32_is_one_mma_chain_of_the_rounded_operands(rng):
    a = torch.as_tensor(rng.normal(size=(2, 5, 16)).astype(np.float32))
    w = torch.as_tensor(rng.normal(size=(16, 7)).astype(np.float32))
    chain = mma_chain(None, round_tf32(a), round_tf32(w))
    assert torch.equal(matmul_1xtf32(a, w), chain)
    batched = matmul_1xtf32(a, w.expand(2, 16, 7))
    assert torch.equal(batched, chain)
