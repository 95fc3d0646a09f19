"""The eval network's plain versions with the kernel's tensor-core products.

Kernel rows 1-3 (``csrc/net_kernel.cuh``) compute every channel product of
the layer stack through ``csrc/tc_gemm.cuh`` (3xTF32 ``mma.sync``, per-k-step
partial sums); ``ops/tf32.py:matmul_3xtf32`` is that arithmetic bit for bit
(chip_smoke.py phase 24).  With it as ``matmul=``, the plain denoiser
(row 1), lifter (row 2) and bare stack (row 3) are held within 5e-5 of the
f32 plain versions, the denoiser and the lifter also of the JAX package's
Pallas kernels (interpret mode) on the same numpy-seeded weights and inputs
(the f32 bare stack is held to make_pallas_backbone_fn by
tests/test_torch_fused_igcn.py), and a fixed-count Anderson eval solve over
the bare stack within 2e-4 of the f32 solve.  The TF32 parts that
``prepare_weights`` gives the kernel are ``split_tf32`` of the f32 stacks,
bit for bit.  The kernel itself
runs only on the card; chip_smoke.py holds it against the f32 plain versions
there.  The TF32 model multiplies term by term in float64, so the batches
are small and the layers few: the Pallas comparisons at the small width the
other interpret-mode tests use (hid 32, one layer: the interpreter's time
grows with the depth), the rest at the kernel's (hid 96, 4 heads, 17
joints).
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffpose_tpu.ops.pallas_denoiser import make_pallas_denoiser, make_pallas_lifter
from diffpose_tpu_torch.models import IGCN, GCNDiff
from diffpose_tpu_torch.ops import fused_denoiser as fd
from diffpose_tpu_torch.ops.fused_igcn import make_igcn_fn
from diffpose_tpu_torch.ops.tf32 import matmul_3xtf32, split_tf32
from test_torch_models import BASIS, CONFIGS, flax_pair

TOL_KERNEL = 5e-5     # chip_smoke.py TOL_KERNEL, tests/test_pallas_denoiser.py
TOL_PIPELINE = 2e-4   # chip_smoke.py TOL_PIPELINE: the eval solves of phase 13
SMALL = dict(CONFIGS[0], num_layers=1)           # hid 32, 4 heads
NET = dict(hid_dim=96, num_layers=2, num_heads=4)  # the kernel's widths
B = 4


def _seeded(model: torch.nn.Module, seed: int) -> torch.nn.Module:
    """The port's model with every term live (the adjacency, LayerNorms and
    biases moved off their init), as chip_smoke.py's ``randomize``."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("A_hat"):
                p.add_(0.1 * torch.rand(p.shape, generator=gen))
            elif name.endswith(("bias", "a_2", "b_2")):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))
    return model.eval()


def _held(got: torch.Tensor, f32: torch.Tensor, want=None):
    """Within the kernel's bound of the f32 plain version (and of the JAX
    kernel), and not equal to it: the TF32 products did run."""
    assert float((got - f32).abs().max()) <= TOL_KERNEL
    assert not torch.equal(got, f32)
    if want is not None:
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL_KERNEL)


def test_denoiser_3xtf32_matches_f32_and_pallas():
    _, params, tm = flax_pair(SMALL, 0, with_temb=True)
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, 17, 5)).astype(np.float32)
    t = np.array([0.0, 12.0, 12.0, 0.0], np.float32)
    want = make_pallas_denoiser(params, BASIS, block_b=B, interpret=True, precision=None,
                                **SMALL)(jnp.asarray(x), jnp.asarray(t))
    w = fd.prepare_weights(tm, device="cpu")
    with torch.no_grad():
        tp = fd.timestep_projections(w, torch.as_tensor(t))
        got = fd.net_plain(w, torch.as_tensor(x), tp, matmul=matmul_3xtf32)
        _held(got, fd.net_plain(w, torch.as_tensor(x), tp), want)


def test_lifter_3xtf32_matches_f32_and_pallas():
    _, params, tm = flax_pair(SMALL, 1, with_temb=False)
    x = np.random.default_rng(1).normal(size=(B, 17, 2)).astype(np.float32)
    want = make_pallas_lifter(params, BASIS, block_b=B, interpret=True, precision=None,
                              **SMALL)(jnp.asarray(x))
    w = fd.prepare_weights(tm, device="cpu")
    with torch.no_grad():
        got = fd.net_plain(w, torch.as_tensor(x), matmul=matmul_3xtf32)
        _held(got, fd.net_plain(w, torch.as_tensor(x)), want)


@pytest.mark.parametrize("layers,batch", [(5, 2), (1, 6)], ids=["implicit", "video"])
def test_backbone_3xtf32_within_kernel_bound(layers, batch):
    """At the depths the main paths run row 3: the implicit family's 5-layer
    stack, and the video family's one spatial layer (6 frames, a ragged
    last tile on the card)."""
    torch.manual_seed(3)
    tm = _seeded(IGCN(BASIS, **dict(NET, num_layers=layers)), 3)
    rng = np.random.default_rng(3)
    z = torch.as_tensor(rng.normal(size=(batch, 17, NET["hid_dim"])).astype(np.float32))
    tp = torch.as_tensor(rng.normal(size=(layers, batch, NET["hid_dim"])).astype(np.float32))
    w = fd.prepare_weights(tm, device="cpu")
    with torch.no_grad():
        _held(fd.backbone_plain(w, z, tp, matmul=matmul_3xtf32), fd.backbone_plain(w, z, tp))


@pytest.mark.parametrize("solver,iterations", [("anderson", 5), ("damped", 20)])
def test_eval_solve_3xtf32_within_pipeline_bound(solver, iterations):
    """The fixed-count eval solves that do not amplify rounding (Anderson
    before its history of 5 fills, the damped solver at full depth:
    chip_smoke.py STABLE_SOLVES) over the TF32 bare stack against the same
    solve over the f32 one."""
    torch.manual_seed(4)
    tm = _seeded(IGCN(BASIS, **NET, solver=solver, max_iterations=iterations,
                      min_iterations=iterations), 4)
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.normal(size=(2, 17, 5)).astype(np.float32))
    t = torch.full((2,), 12.0)
    w = fd.prepare_weights(tm, device="cpu")
    tf32_stack = functools.partial(fd.backbone_plain, matmul=matmul_3xtf32)
    out, aux = make_igcn_fn(tm, device="cpu", backbone=tf32_stack)(w, tm, x, t)
    want, want_aux = make_igcn_fn(tm, device="cpu", backbone=fd.backbone_plain)(w, tm, x, t)
    assert aux["iterations"] == want_aux["iterations"] == iterations
    assert float((out - want).abs().max()) <= TOL_PIPELINE
    assert float((aux["fixed_point"] - want_aux["fixed_point"]).abs().max()) <= TOL_PIPELINE
    assert not torch.equal(out, want)


def test_prepared_tf32_parts_are_split_tf32():
    """Each channel product's stack as the kernel takes it, ``[L, 2, K, N]``:
    ``split_tf32`` of the f32 stack, bit for bit; none in training weights."""
    torch.manual_seed(5)
    model = _seeded(GCNDiff(BASIS, **NET), 5)
    w = fd.prepare_weights(model, device="cpu")
    for k in fd.SPLIT_KEYS:
        parts = w[f"{k}_tf32"]
        assert parts.shape == (NET["num_layers"], 2) + w[k].shape[1:] and parts.is_contiguous()
        for i, want in enumerate(split_tf32(w[k])):
            assert torch.equal(parts[:, i].contiguous().view(torch.int32), want.view(torch.int32))
    train = fd.prepare_weights(model.train(), device="cpu", differentiable=True)
    assert not [k for k in train if k.endswith("_tf32")]


def test_net_levers_variants_patch_the_sources(tmp_path):
    """Each variant of ``probes/net_levers.py`` (built and timed on the card)
    finds what it patches in the committed sources and changes them."""
    import shutil

    from diffpose_tpu_torch.ops import _build
    from diffpose_tpu_torch.probes import net_levers

    names = ("net_kernel.cuh", "tc_gemm.cuh", "net_kernel.cu")
    for name, patch in net_levers.VARIANTS.items():
        d = tmp_path / name
        shutil.copytree(_build.CSRC, d)
        if patch is not None:
            patch(d)
            assert any((d / f).read_text() != (_build.CSRC / f).read_text() for f in names), name
