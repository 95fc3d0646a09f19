"""Philox4x32-10 and the seeded dropout of the fused train stack, on the CPU:
the generator against Random123's known answers, the masks' statistics and
keying, and the seeded forward/backward against the JAX package's reference
fed the same masks."""

import copy

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffpose_tpu.ops import train_ref as jref
from diffpose_tpu_torch.data.synthetic import make_synthetic_dataset
from diffpose_tpu_torch.diffusion import get_beta_schedule
from diffpose_tpu_torch.models import convert
from diffpose_tpu_torch.models.ema import ema_register
from diffpose_tpu_torch.ops import fused_train as ft
from diffpose_tpu_torch.ops.fused_denoiser import _cheb, prepare_weights, timestep_projections
from diffpose_tpu_torch.ops.philox import keep_thresholds, philox4x32_10, philox_masks
from diffpose_tpu_torch.train.optim import make_optimizer
from diffpose_tpu_torch.train.state import TrainState
from diffpose_tpu_torch.train.steps import make_train_step
from test_torch_models import BASIS, CONFIGS, flax_pair
from test_torch_train_ref import grads_close

# Small tensors on a host that runs several test workers: one thread each is
# faster than contended thread pools.
torch.set_num_threads(1)

SMALL = CONFIGS[0]
SHAPE = dict(num_layers=2, n_pts=17, num_heads=4, hid_dim=32)
BETAS = get_beta_schedule("linear", beta_start=1e-4, beta_end=1e-3, num_diffusion_timesteps=51)

# Random123's kat_vectors for philox4x32 with 10 rounds: counter, key, result.
KNOWN_ANSWERS = [
    ([0, 0, 0, 0], [0, 0], [0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8]),
    ([0xFFFFFFFF] * 4, [0xFFFFFFFF] * 2, [0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD]),
    ([0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344], [0xA4093822, 0x299F31D0],
     [0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1]),
]


def philox_ints(counter, key):
    """A second implementation, in plain Python integers."""
    c, k = list(counter), list(key)
    for _ in range(10):
        p0, p1 = 0xD2511F53 * c[0], 0xCD9E8D57 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & 0xFFFFFFFF, (p0 >> 32) ^ c[3] ^ k[1], p0 & 0xFFFFFFFF]
        k = [(k[0] + 0x9E3779B9) & 0xFFFFFFFF, (k[1] + 0xBB67AE85) & 0xFFFFFFFF]
    return c


@pytest.mark.parametrize("counter,key,want", KNOWN_ANSWERS, ids=["zeros", "ones", "pi"])
def test_known_answers(counter, key, want):
    got = philox4x32_10(np.asarray(counter, np.uint64), key)
    assert [int(v) for v in got] == want
    assert philox_ints(counter, key) == want


def test_vectorized_equals_python_ints(rng):
    counters = rng.integers(0, 2 ** 32, size=(7, 4), dtype=np.uint64)
    key = (0x87654321, 19)
    got = philox4x32_10(counters, key)
    for c, g in zip(counters, got):
        assert [int(v) for v in g] == philox_ints([int(v) for v in c], key)


def test_keep_rates_and_layout():
    m = philox_masks(20240607, batch=48, **SHAPE)
    assert m.probs.shape == (2, 48, 4, 17, 17) and m.cheb2.shape == (2, 48, 17, 32)
    assert all(v.dtype == torch.uint8 and int(v.max()) == 1 for v in m)
    for got, want in zip(m, (0.9, 0.75, 0.75, 0.9, 0.9)):
        assert abs(float(got.float().mean()) - want) < 0.01
    ones = philox_masks(1, batch=2, rates=(0.0, 0.0, 0.0), **SHAPE)
    assert all(bool((v == 1).all()) for v in ones)
    # one element by hand: layer 1, stream 3 (cheb1), sample 5, joint 9, column 22
    words = philox_ints([9 * (32 // 4) + 22 // 4, 5, 0, 0], [20240607, 1 * 8 + 3])
    assert int(m.cheb1[1, 5, 9, 22]) == int((words[22 % 4] >> 9) < keep_thresholds()[2])
    # and one attention probability: layer 0, sample 3, head 2, query 11, key 6
    words = philox_ints([((2 * 17 + 11) << 3) + 6 // 4, 3, 0, 0], [20240607, 0])
    assert int(m.probs[0, 3, 2, 11, 6]) == int((words[6 % 4] >> 9) < keep_thresholds()[0])


def test_masks_differ_across_layer_sample_stream_and_seed():
    m = philox_masks(-7, batch=8, **SHAPE)          # a negative int32 seed
    again = philox_masks(torch.tensor([-7], dtype=torch.int32), batch=8, **SHAPE)
    other = philox_masks(-6, batch=8, **SHAPE)
    assert all(torch.equal(a, b) for a, b in zip(m, again))
    assert all(not torch.equal(a, b) for a, b in zip(m, other))
    assert not torch.equal(m.attn_out[0], m.attn_out[1])            # layers
    assert not torch.equal(m.attn_out[:, 0], m.attn_out[:, 1])      # samples
    assert not torch.equal(m.attn_out, m.gnet_out)                  # streams, one rate
    assert not torch.equal(m.cheb1, m.cheb2)
    assert not torch.equal(m.probs[:, :, 0], m.probs[:, :, 1])      # heads
    # keyed on the sample, not on the batch: a smaller batch is a prefix
    few = philox_masks(-7, batch=3, **SHAPE)
    assert all(torch.equal(a[:, :3], b) for a, b in zip(m, few))


def test_seeded_wrappers_on_cpu_use_philox_masks(rng):
    _, _, tm = flax_pair(SMALL, 0, with_temb=True)
    w = prepare_weights(tm, device="cpu")
    b = 5
    h0 = torch.as_tensor(rng.normal(size=(b, 17, 32)).astype(np.float32))
    tp = torch.as_tensor(rng.normal(size=(2, b, 32)).astype(np.float32))
    dd5 = torch.as_tensor(rng.normal(size=(b, 17, 32)).astype(np.float32))
    seed = torch.tensor([123456789], dtype=torch.int32)
    masks = philox_masks(seed, batch=b, **SHAPE)
    ft.stack_fwd_prng.launches = ft.stack_bwd_prng.launches = 0
    with torch.no_grad():
        d5, st, dumped = ft.stack_fwd_prng(w, h0, tp, seed, dump=True)
        want, want_st = ft.stack_fwd(w, h0, tp, ft.kernel_masks(masks))
        got_b = ft.stack_bwd_prng(w, seed, st, dd5)
        want_b = ft.stack_bwd_plain(w, masks, st, dd5)
    assert all(torch.equal(dumped[k], getattr(masks, k)) for k in ft.MASK_KEYS)
    assert torch.equal(d5, want) and all(torch.equal(st[k], want_st[k]) for k in st)
    assert torch.equal(got_b[0], want_b[0]) and torch.equal(got_b[1], want_b[1])
    assert all(torch.equal(got_b[2][k], want_b[2][k]) for k in ft.DSTASH_KEYS)
    assert (ft.stack_fwd_prng.launches, ft.stack_bwd_prng.launches) == (0, 0)
    stack = ft.build_train_stack(BASIS, dropout="prng", **SMALL)
    with pytest.raises(ValueError, match="seed tensor"):
        stack(w, h0, tp, masks)
    assert stack.run_fwd_dump is not None
    assert ft.build_train_stack(BASIS, **SMALL).run_fwd_dump is None


def test_prng_train_step_equals_plain_step_given_the_same_masks():
    _, _, tm = flax_pair(SMALL, 1, with_temb=True)
    data = make_synthetic_dataset(num_frames=16, seed=0)
    batch = {"poses_3d": data.poses_3d, "poses_2d_gmm": data.poses_2d_gmm}

    def fresh(impl, dropout):
        model = copy.deepcopy(tm).train()
        opt = make_optimizer(model.parameters(), lr=1e-3, eps=1e-4)
        state = TrainState.create(model, opt, ema_register(model))
        return state, make_train_step(model, opt, BETAS, impl=impl, device="cpu", dropout=dropout)

    f_state, f_step = fresh("fused", "prng")
    p_state, p_step = fresh("plain", "masks")
    gen = torch.Generator().manual_seed(5)
    for _ in range(2):
        draws = f_step.draw(batch, gen)
        assert draws.masks is None and draws.seed.dtype == torch.int32 and draws.seed.shape == (1,)
        masks = philox_masks(draws.seed, batch=16, dtype=torch.float32, **SHAPE)
        f_state, fm = f_step.apply(f_state, draws)
        p_state, pm = p_step.apply(p_state, draws._replace(masks=masks, seed=None))
        assert abs(float(fm["loss"]) - float(pm["loss"])) <= 1e-6 * abs(float(pm["loss"]))
    for a, b in zip(f_state.model.parameters(), p_state.model.parameters()):
        assert float((a - b).abs().max()) <= 1e-6
    with pytest.raises(ValueError, match="nn.Dropout"):
        make_train_step(tm, f_state.optimizer, BETAS, impl="module", device="cpu", dropout="prng")


def test_prng_forward_gradients_match_jax_grad_with_the_same_masks(rng):
    """The seeded fused forward under autograd against ``jax.grad`` of the JAX
    package's reference, which is handed the masks the seed gives."""
    _, params, tm = flax_pair(SMALL, 2, with_temb=True)
    b = 6
    x = rng.normal(size=(b, 17, 5)).astype(np.float32)
    t = rng.integers(0, 51, size=b).astype(np.float32)
    e = rng.normal(size=(b, 17, 5)).astype(np.float32)
    seed = torch.tensor([-2024], dtype=torch.int32)
    m = philox_masks(seed, batch=b, dtype=torch.float32, **SHAPE)
    jmasks = jref.DropoutMasks(
        probs=jnp.asarray(m.probs.permute(0, 3, 4, 1, 2).numpy()),
        **{k: jnp.asarray(getattr(m, k).permute(0, 2, 1, 3).numpy())
           for k in ("attn_out", "gnet_out", "cheb1", "cheb2")})

    def loss_ref(p):
        out = jref.train_forward(p, BASIS, jnp.asarray(x), jnp.asarray(t), jmasks, **SMALL)
        return jnp.mean(jnp.sum((jnp.asarray(e) - out) ** 2, axis=(1, 2)))

    want_loss, want = jax.jit(jax.value_and_grad(loss_ref))(params)
    stack = ft.build_train_stack(BASIS, dropout="prng", **SMALL)
    out = ft.fused_train_forward(tm.train(), torch.as_tensor(x), torch.as_tensor(t), seed, stack)
    loss = ((torch.as_tensor(e) - out) ** 2).sum(dim=(1, 2)).mean()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-5)
    names = [n for n, _ in tm.named_parameters()]
    grads = dict(zip(names, torch.autograd.grad(loss, list(tm.parameters()))))
    grads_close(convert.flax_from_state_dict(grads, with_temb=True, num_layers=2), want)
    # the weights' own path agrees with the plain wrappers
    w = prepare_weights(tm, device="cpu")
    with torch.no_grad():
        h0 = _cheb(torch.as_tensor(x), w["win"], w["bin"], w["basis"])
        d5, _ = stack.run_fwd(w, h0, timestep_projections(w, torch.as_tensor(t)), seed)
    assert d5.shape == (b, 17, 32)
