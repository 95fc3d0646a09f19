"""Plain versions of the fused forwards vs the JAX Pallas kernels (interpret
mode) and vs the port's own modules; the CUDA wrapper's input checks.

The CUDA kernel itself runs only on the card; chip_smoke.py holds it
against these plain versions there.
"""

import math

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from diffpose_tpu.ops.pallas_cheb import _sparse_terms
from diffpose_tpu.ops.pallas_denoiser import make_pallas_denoiser, make_pallas_lifter
from diffpose_tpu_torch.ops import fused_denoiser as fd
from test_torch_models import BASIS, CONFIGS, flax_pair

SMALL, FULL = CONFIGS


def test_denoiser_plain_matches_pallas_interpret(rng):
    _, params, tm = flax_pair(SMALL, 0, with_temb=True)
    x = rng.normal(size=(8, 17, 5)).astype(np.float32)
    t = np.linspace(0, 50, 8).astype(np.float32)
    want = np.asarray(make_pallas_denoiser(params, BASIS, block_b=8, interpret=True,
                                           precision=None, **SMALL)(jnp.asarray(x), jnp.asarray(t)))
    w = fd.prepare_weights(tm, device="cpu")
    with torch.no_grad():
        got = fd.fused_denoiser(w, torch.as_tensor(x), torch.as_tensor(t)).numpy()
        module = tm(torch.as_tensor(x), torch.as_tensor(t)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5)
    np.testing.assert_allclose(got, module, atol=5e-5)


def test_lifter_plain_matches_pallas_interpret(rng):
    _, params, tm = flax_pair(SMALL, 1, with_temb=False)
    x = rng.normal(size=(8, 17, 2)).astype(np.float32)
    want = np.asarray(make_pallas_lifter(params, BASIS, block_b=8, interpret=True,
                                         precision=None, **SMALL)(jnp.asarray(x)))
    w = fd.prepare_weights(tm, device="cpu")
    with torch.no_grad():
        got = fd.fused_lifter(w, torch.as_tensor(x)).numpy()
        module = tm(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5)
    np.testing.assert_allclose(got, module, atol=5e-5)


@pytest.mark.parametrize("with_temb", [True, False], ids=["denoiser", "lifter"])
def test_full_width_plain_matches_module(rng, with_temb):
    _, _, tm = flax_pair(FULL, 2, with_temb)
    w = fd.prepare_weights(tm, device="cpu")
    c_in = 5 if with_temb else 2
    x = torch.as_tensor(rng.normal(size=(4, 17, c_in)).astype(np.float32))
    t = torch.tensor([0.0, 12.0, 12.0, 0.0])
    with torch.no_grad():
        if with_temb:
            got, want = fd.fused_denoiser(w, x, t), tm(x, t)
        else:
            got, want = fd.fused_lifter(w, x), tm(x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-5)


def test_weight_prep_folds_q_scale():
    _, _, tm = flax_pair(SMALL, 3, with_temb=True)
    w = fd.prepare_weights(tm, device="cpu")
    h = SMALL["hid_dim"]
    scale = 1.0 / math.sqrt(h // SMALL["num_heads"])
    attn = tm.atten_layers[1].self_attn.linears
    q_w, q_b = attn[0].weight.detach().t() * scale, attn[0].bias.detach() * scale
    torch.testing.assert_close(w["wqkv"][1, :, :h], q_w, rtol=0, atol=0)
    torch.testing.assert_close(w["bqkv"][1, :h], q_b, rtol=0, atol=0)
    torch.testing.assert_close(w["wqkv"][1, :, h:2 * h], attn[1].weight.detach().t(), rtol=0, atol=0)


def test_sparse_terms_cover_the_basis():
    ptr, idx, val = fd.sparse_terms(BASIS.astype(np.float64))
    dense = np.zeros_like(BASIS)
    for n in range(17):
        for e in range(ptr[n], ptr[n + 1]):
            dense[idx[e] >> 8, n, idx[e] & 0xFF] = val[e]
    np.testing.assert_array_equal(dense, BASIS)
    # orders k >= 1 are the TPU kernel's compile-time term list
    tpu = _sparse_terms(BASIS.astype(np.float64))
    for n in range(17):
        ours = [(int(idx[e]) >> 8, int(idx[e]) & 0xFF, float(val[e]))
                for e in range(ptr[n], ptr[n + 1]) if idx[e] >> 8]
        assert [(k, m) for k, m, _ in ours] == [(k, m) for k, m, _ in tpu[n]]
        np.testing.assert_allclose([c for *_, c in ours], [c for *_, c in tpu[n]], rtol=1e-7)


def test_kernel_wrapper_rejects_what_it_does_not_take():
    _, _, small = flax_pair(SMALL, 4, with_temb=True)
    _, _, full = flax_pair(FULL, 4, with_temb=False)
    ws, wf = fd.prepare_weights(small, device="cpu"), fd.prepare_weights(full, device="cpu")
    with pytest.raises(ValueError, match="built for"):
        fd._launch(ws, torch.zeros(2, 17, 5), torch.zeros(2, 2, 32))
    with pytest.raises(ValueError, match="CUDA tensors"):
        fd._launch(wf, torch.zeros(2, 17, 2), None)
    with pytest.raises(ValueError, match="GCNPose"):
        fd.fused_lifter(ws, torch.zeros(2, 17, 2))
    with pytest.raises(ValueError, match="GCNDiff"):
        fd.fused_denoiser(wf, torch.zeros(2, 17, 5), torch.zeros(2))
