"""The plain model of the train kernels' tensor-core products (ops/tf32.py)
against float64, float32 and the JAX package: the TF32 split, one fused
mma sum that truncates, one 3xTF32 product with per-k-step partials (as
csrc/train_kernel.cuh:tc_gemm) and over the whole K (the design it
replaced), and the whole plain train stack at full width (hid 96, 4 heads,
17 joints) forward and backward with every channel product so computed, at
5 layers and at the video family's 1 layer with a ragged batch.  That the
model equals mma.sync bit for bit is held on the card (chip_smoke.py phase
24, probes/tf32_gemm.py); the f32 plain stack is held to the JAX package by
tests/test_torch_train_ref.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpose_tpu.ops import train_ref as jref
from diffpose_tpu.ops.pallas_denoiser import _prep_weights

from diffpose_tpu_torch.graph import H36M_EDGES, cheb_basis_from_edges
from diffpose_tpu_torch.models import GCNDiff
from diffpose_tpu_torch.ops import fused_train as ft
from diffpose_tpu_torch.ops.fused_denoiser import prepare_weights, timestep_projections
from diffpose_tpu_torch.ops.philox import philox_masks
from diffpose_tpu_torch.ops.tf32 import matmul_3xtf32, mma_chain, round_tf32, split_tf32
from diffpose_tpu_torch.ops.train_ref import layers_forward
from diffpose_tpu_torch.probes import tf32_gemm
from test_torch_models import BASIS, CONFIGS, flax_pair
from test_torch_train_ref import jax_masks, numpy_masks, to_port_masks

TOL_FWD = 5e-5                    # chip_smoke.py TOL_KERNEL, tests/test_pallas_denoiser.py
GRAD_ABS, GRAD_REL = 1e-5, 1e-3   # tests/test_pallas_train.py:64-71
STACKS = [(5, 4), (1, 6)]         # (layers, batch): the frame/implicit stack; the video's, ragged


def test_split_properties():
    rng = np.random.default_rng(0)
    x = torch.as_tensor(np.concatenate([rng.standard_normal(4096) * 10.0 ** rng.integers(-6, 6, 4096),
                                        [0.0, -0.0, 1.0, -3.5]]).astype(np.float32))
    big, small = split_tf32(x)
    for part in (big, small):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0   # ≤ 10 stored mantissa bits
    rel = ((big.double() + small.double() - x.double()).abs() / x.double().abs().clamp_min(1e-30))
    assert float(rel.max()) <= 2.0 ** -22
    assert float((big - x).abs().max() / x.abs().max()) <= 2.0 ** -11


def test_round_ties_away_from_zero():
    one = int(np.float32(1.0).view(np.int32))
    x = np.array([one + 0x1000, one + 0xFFF, one + 0x3000], dtype=np.int32).view(np.float32)
    want = np.array([one + 0x2000, one, one + 0x4000], dtype=np.int32).view(np.float32)
    got = round_tf32(torch.as_tensor(np.concatenate([x, -x]))).numpy()
    np.testing.assert_array_equal(got, np.concatenate([want, -want]))


def test_matmul_3xtf32_close_to_f64():
    rng = np.random.default_rng(1)
    a = torch.as_tensor(rng.standard_normal((72, 288)).astype(np.float32))
    w = torch.as_tensor((rng.standard_normal((288, 96)) / 17).astype(np.float32))
    want = a.double() @ w.double()
    err3 = float((matmul_3xtf32(a, w).double() - want).abs().max())
    err32 = float(((a @ w).double() - want).abs().max())
    err1 = float(((round_tf32(a) @ round_tf32(w)).double() - want).abs().max())
    assert err3 < 4 * err32 + 1e-6 and err3 < err1 / 30


@pytest.mark.parametrize("c", [1.0, -1.0])
def test_mma_truncates_each_term(c):
    """One mma: eight products of 2⁻²⁶ fall below the window of 26 bits
    under the accumulator's exponent and are cut away (round-to-nearest of
    the exact sum would keep 2⁻²³); eight of 2⁻²⁵ are kept."""
    acc = torch.tensor([[c]])
    for b_scale, want in ((2.0 ** -13, c), (2.0 ** -12, c + 2.0 ** -22)):
        a, b = torch.full((1, 8), 2.0 ** -13), torch.full((8, 1), b_scale)
        assert float(mma_chain(acc, a, b)) == want


def test_whole_k_accumulation_is_biased():
    """Fed the whole K, the truncation pulls every result toward zero (the
    design replaced in the train kernels); k-step partials added with
    round-to-nearest leave a bias 10× smaller."""
    rng = np.random.default_rng(2)
    a = torch.as_tensor(rng.standard_normal((136, 288)).astype(np.float32))
    w = torch.as_tensor((rng.standard_normal((288, 96)) / 17).astype(np.float32))
    exact = a.double() @ w.double()
    bias = {}
    for mode in ("kstep", "whole_k"):
        d = matmul_3xtf32(a, w, accumulate=mode).double() - exact
        bias[mode] = float((d * exact.sign()).mean())
        if mode == "whole_k":
            assert bias[mode] < -0.5 * float(d.abs().mean())
    assert abs(bias["kstep"]) < abs(bias["whole_k"]) / 10


def test_probe_gemm_on_cpu_is_the_plain_model():
    """The card's check (probes/tf32_gemm.py) compares the kernel with these
    functions; on CPU tensors the wrapper is them and launches nothing."""
    g = torch.Generator().manual_seed(4)
    a, w, c0 = (torch.randn(*shape, generator=g) for shape in ((16, 24), (24, 16), (16, 16)))
    before = tf32_gemm.gemm.launches
    assert torch.equal(tf32_gemm.gemm(a, w, c0, "1xtf32"),
                       mma_chain(c0, round_tf32(a), round_tf32(w)))
    for mode in ("kstep", "whole_k"):
        assert torch.equal(tf32_gemm.gemm(a, w, mode=mode), matmul_3xtf32(a, w, accumulate=mode))
    assert tf32_gemm.gemm.launches == before
    with pytest.raises(ValueError):
        tf32_gemm.gemm(a, w, mode="2xtf32")


def _stack(layers, batch, seed=0):
    gen = torch.Generator().manual_seed(seed)
    model = GCNDiff(cheb_basis_from_edges(17, H36M_EDGES), num_layers=layers)
    with torch.no_grad():   # every term live, as chip_smoke.py's randomize
        for name, p in model.named_parameters():
            if name.endswith("A_hat"):
                p.add_(0.1 * torch.rand(p.shape, generator=gen))
            elif name.endswith(("bias", "a_2", "b_2")):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    w = prepare_weights(model, device="cpu")
    rng = np.random.default_rng(seed)
    h0 = torch.as_tensor(rng.standard_normal((batch, 17, 96)).astype(np.float32))
    t = torch.as_tensor(rng.integers(0, 50, batch).astype(np.float32))
    with torch.no_grad():
        tp = timestep_projections(w, t)
    masks = philox_masks(torch.tensor([1234 + seed], dtype=torch.int32), num_layers=layers,
                         batch=batch, dtype=torch.float32)
    return w, h0, tp, masks, rng


@pytest.mark.parametrize("layers,batch", STACKS, ids=lambda v: str(v))
def test_forward_3xtf32_within_kernel_bound(layers, batch):
    w, h0, tp, masks, _ = _stack(layers, batch)
    with torch.no_grad():
        d5, st = layers_forward(w, h0, tp, masks, return_stashes=True)
        d5e, ste = layers_forward(w, h0, tp, masks, return_stashes=True, matmul=matmul_3xtf32)
    errs = {"d5": float((d5e - d5).abs().max()), **{k: float((ste[k] - st[k]).abs().max()) for k in st}}
    assert max(errs.values()) <= TOL_FWD, errs


@pytest.mark.parametrize("layers,batch", STACKS, ids=lambda v: str(v))
def test_backward_3xtf32_within_grad_limits(layers, batch):
    w, h0, tp, masks, rng = _stack(layers, batch)
    with torch.no_grad():
        _, st = layers_forward(w, h0, tp, masks, return_stashes=True)
        dd5 = torch.as_tensor(rng.standard_normal((batch, 17, 96)).astype(np.float32))
        want = ft.stack_bwd_plain(w, masks, st, dd5)
        got = ft.stack_bwd_plain(w, masks, st, dd5, matmul=matmul_3xtf32)
    pairs = {"dA0": (got[0], want[0]), "dtp": (got[1], want[1]),
             **{k: (got[2][k], want[2][k]) for k in ft.DSTASH_KEYS}}
    for name, (g, r) in pairs.items():
        d = float((g - r).abs().max())
        assert d < GRAD_ABS or d / (float(r.abs().max()) + 1e-8) < GRAD_REL, (name, d)


def test_forward_3xtf32_matches_jax_reference():
    """The stack with the kernels' products against the JAX package's
    pure-JAX reference (f32) on the same weights, inputs and masks."""
    cfg, rng = CONFIGS[1], np.random.default_rng(3)
    _, params, tm = flax_pair(cfg, 0, with_temb=True)
    b, hid, L = 4, cfg["hid_dim"], cfg["num_layers"]
    h = rng.normal(size=(b, 17, hid)).astype(np.float32)
    tp = rng.normal(size=(L, b, hid)).astype(np.float32)
    m = numpy_masks(rng, cfg, b)
    jw, _, _, _ = _prep_weights(params, BASIS, L, cfg["num_heads"], hid)
    want = jref.layers_forward(jw, jnp.asarray(h.transpose(1, 0, 2)), jnp.asarray(tp), jax_masks(m),
                               basis=BASIS, **cfg)
    w = prepare_weights(tm, device="cpu")
    with torch.no_grad():
        got = layers_forward(w, torch.as_tensor(h), torch.as_tensor(tp), to_port_masks(m),
                             matmul=matmul_3xtf32)
    np.testing.assert_allclose(got.numpy(), np.asarray(want).transpose(1, 0, 2), atol=TOL_FWD)
