"""The probes' plain twins (kernel rows 11 and 12) vs the JAX probes' Pallas
kernels (interpret mode) and vs the port's own modules.

The probe kernels themselves run only on the card; chip_smoke.py holds them
against these plain twins there.
"""

import functools
import importlib.util
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.experimental import pallas as pl

from diffpose_tpu_torch.ops import fused_denoiser as fd
from diffpose_tpu_torch.probes import ablate, batched_dot
from test_torch_models import BASIS, CONFIGS, flax_pair

SMALL, FULL = CONFIGS
SCRIPTS = Path(__file__).resolve().parents[1] / "scripts"


def _script(name):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_batched_dot_plain_matches_pallas_interpret(rng):
    probe = _script("probe_batched_dot")
    q, k, v = (rng.normal(size=(4, 9, 24)).astype(np.float32) for _ in range(3))
    call = pl.pallas_call(probe.kernel, out_shape=jax.ShapeDtypeStruct((4, 9, 24), jnp.float32),
                          interpret=True)
    want = np.asarray(call(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    before = batched_dot.batched_attention.launches
    got = batched_dot.batched_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v))
    assert batched_dot.batched_attention.launches == before
    np.testing.assert_allclose(got.numpy(), want, atol=5e-5)


def small_denoiser(rng, seed):
    _, _, tm = flax_pair(SMALL, seed, with_temb=True)
    w = fd.prepare_weights(tm, device="cpu")
    x = torch.as_tensor(rng.normal(size=(5, 17, 5)).astype(np.float32))
    t = torch.tensor([0.0, 5.0, 12.0, 30.0, 50.0])
    return tm, w, x, t, fd.timestep_projections(w, t)


def test_net_plain_ablated_without_skip_is_net_plain(rng):
    _, w, x, _, tp = small_denoiser(rng, 0)
    with torch.no_grad():
        np.testing.assert_allclose(ablate.net_plain_ablated(w, x, tp, ()).numpy(),
                                   fd.net_plain(w, x, tp).numpy(), atol=1e-6)
        np.testing.assert_allclose(ablate.probe_forward(w, x, tp).numpy(),
                                   fd.net_plain(w, x, tp).numpy(), atol=1e-6)


def by_hand(tm, x, t, skip):
    """The GCNDiff module's own sublayers, composed with the parts in ``skip``
    left out (eval mode: every dropout is the identity)."""
    temb = tm.temb(t)
    h = tm.gconv_input(x)
    eye = torch.eye(x.shape[1])
    for atten, res in zip(tm.atten_layers, tm.gconv_layers):
        norm1, norm2 = ((lambda z: z, lambda z: z) if "ln" in skip
                        else (atten.sublayer[0].norm, atten.sublayer[1].norm))
        if "attn" not in skip:
            h = h + atten.self_attn(norm1(h))
        if "gnetcheb" in skip:
            continue
        ff = atten.feed_forward
        h = h + (ff.gconv2(ff.gconv1(norm2(h), eye), eye) if "lap" in skip else ff(norm2(h)))
        h = res(h, temb)
    return tm.gconv_output(h)


@pytest.mark.parametrize("variant", ["no_attn", "attn_only", "no_lap", "no_ln"])
def test_ablated_variant_matches_module_by_hand(rng, variant):
    tm, w, x, t, tp = small_denoiser(rng, 1)
    parts = ablate.VARIANTS[variant]
    with torch.no_grad():
        want = by_hand(tm, x, t, parts)
        got = ablate.net_plain_ablated(w, x, tp, parts)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=5e-5)


def test_no_chebmix_matches_probe_ablate_kernel_interpret(rng):
    """The JAX probe's kernel (hid 96, 5 layers, 4 heads: its constants) in
    interpret mode at f32 products, B=8."""
    probe = _script("probe_ablate")
    _, params, tm = flax_pair(FULL, 2, with_temb=True)
    w = fd.prepare_weights(tm, device="cpu")
    x = rng.normal(size=(8, 17, 5)).astype(np.float32)
    t = torch.as_tensor(np.linspace(0, 50, 8).astype(np.float32))
    tp = fd.timestep_projections(w, t)
    weights, terms, seg, segt = probe._prep_weights(params, BASIS, probe.LAYERS, probe.HEADS,
                                                    probe.HID)
    kernel = functools.partial(probe._kernel, terms=terms, n_pts=17, precision=None,
                               skip=frozenset({"chebmix"}))
    call = pl.pallas_call(kernel, out_shape=jax.ShapeDtypeStruct((17, 8, 5), jnp.float32),
                          interpret=True)
    out = call(jnp.asarray(x.transpose(1, 0, 2)), jnp.asarray(tp.numpy()),
               *[weights[k] for k in probe._W_ORDER], seg, segt)
    want = np.asarray(out).transpose(1, 0, 2)
    with torch.no_grad():
        got = ablate.net_plain_ablated(w, torch.as_tensor(x), tp, ("chebmix",)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_every_tpu_variant_is_ported_or_not_applicable():
    names = set(_script("probe_ablate").VARIANTS)
    assert set(ablate.VARIANTS) | set(ablate.NOT_APPLICABLE) == names
    assert not set(ablate.VARIANTS) & set(ablate.NOT_APPLICABLE)
    with pytest.raises(ValueError, match="unknown parts"):
        ablate.skip_bits(("onepass",))
