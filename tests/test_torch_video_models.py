"""Port video model, converters, chunked attention and window datasets vs the
JAX package (diffpose_tpu/models/video.py, models/layers.py:chunked_attention,
data/video.py), on the CPU."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffpose_tpu.data import video as jvideo
from diffpose_tpu.models import layers as jlayers
from diffpose_tpu.models.video import SpatioTemporalDiff as JSpatioTemporalDiff
from diffpose_tpu_torch.data import video
from diffpose_tpu_torch.models import convert, layers
from diffpose_tpu_torch.models.video import SpatioTemporalDiff
from diffpose_tpu_torch.parallel.mesh import distributed_init, distributed_shutdown, make_mesh
from test_torch_models import BASIS, perturbed

torch.set_num_threads(1)

SMALL = dict(frames=5, hid_dim=32, num_layers=2, num_heads=4)


def video_pair(seed, dropout_rate=0.1, attention_chunk=256, **cfg):
    """The port's SpatioTemporalDiff (eval mode) from a seeded init with every
    parameter moved off it, its weights as a Flax tree
    (``flax_video_from_state_dict``, held to a Flax init by
    ``test_converters_round_trip_exactly``), and the Flax module."""
    cfg = dict(SMALL, **cfg)
    torch.manual_seed(seed)
    tm = SpatioTemporalDiff(BASIS, dropout_rate=dropout_rate, attention_chunk=attention_chunk, **cfg)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in tm.named_parameters():
            if name.endswith("A_hat"):
                p.add_(0.1 * torch.rand(p.shape, generator=gen))
            else:
                p.add_(0.05 * torch.randn(p.shape, generator=gen))
    jm = JSpatioTemporalDiff(basis=BASIS, dropout_rate=dropout_rate,
                             attention_chunk=attention_chunk, **cfg)
    return jm, convert.flax_video_from_state_dict(tm.state_dict()), tm.eval()


def inputs(rng, b, frames):
    x = rng.normal(size=(b, frames, 17, 5)).astype(np.float32)
    t = rng.integers(0, 51, size=(b,)).astype(np.float32)
    return x, t


@pytest.mark.parametrize("cfg", [{}, dict(frames=9, attention_chunk=4)], ids=["f5", "f9_chunked"])
def test_spatio_temporal_diff_matches_flax(rng, cfg):
    """Eval forward, and at chunk 4 < 9 frames the chunked attention path."""
    jm, params, tm = video_pair(0, **cfg)
    x, t = inputs(rng, 3, tm.frames)
    want = np.asarray(jax.jit(jm.apply)({"params": params}, jnp.asarray(x), jnp.asarray(t)))
    with torch.no_grad():
        got = tm(torch.as_tensor(x), torch.as_tensor(t)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5)


def test_train_mode_at_rates_0_and_its_gradients_match_flax(rng):
    """``train()`` with every dropout at 0 is the eval forward; its gradients
    against jax.grad of model.apply."""
    jm, params, tm = video_pair(1, dropout_rate=0.0)
    tm.train()
    for mod in tm.modules():
        if isinstance(mod, torch.nn.Dropout):
            mod.p = 0.0
    x, t = inputs(rng, 2, tm.frames)
    e = rng.normal(size=x.shape).astype(np.float32)

    def jloss(p):
        return jnp.mean(jnp.sum((e - jm.apply({"params": p}, jnp.asarray(x), jnp.asarray(t))) ** 2,
                                axis=(1, 2, 3)))

    jgrads = jax.jit(jax.grad(jloss))(params)
    out = tm(torch.as_tensor(x), torch.as_tensor(t))
    ((torch.as_tensor(e) - out) ** 2).sum(dim=(1, 2, 3)).mean().backward()
    got = convert.flax_video_from_state_dict({k: p.grad for k, p in tm.named_parameters()})
    for (path, want), (_, g) in zip(jax.tree_util.tree_leaves_with_path(jgrads),
                                    jax.tree_util.tree_leaves_with_path(got)):
        d = float(np.abs(np.asarray(g) - np.asarray(want)).max())
        assert d < 1e-5 or d / float(np.abs(np.asarray(want)).max()) < 1e-3, jax.tree_util.keystr(path)


def test_converters_round_trip_exactly():
    """A Flax init → the port's state_dict (strict load) → the Flax tree, exactly."""
    jm = JSpatioTemporalDiff(basis=BASIS, **SMALL)
    params = perturbed(jax.jit(jm.init)({"params": jax.random.PRNGKey(2)},
                                        jnp.zeros((2, SMALL["frames"], 17, 5)),
                                        jnp.zeros((2,)))["params"], 2)
    sd = convert.state_dict_from_flax_video(params)
    tm = SpatioTemporalDiff(BASIS, **SMALL)
    tm.load_state_dict(sd, strict=True)
    back = convert.flax_video_from_state_dict(tm.state_dict())
    assert (jax.tree_util.tree_structure(back)
            == jax.tree_util.tree_structure(jax.tree_util.tree_map(np.asarray, params)))
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b)
    again = convert.state_dict_from_flax_video(back)
    assert all(torch.equal(again[k], v) for k, v in sd.items()) and set(again) == set(sd)
    assert "temporal_1.attn.q.weight" in sd and "spatial_res_0.temb_proj.bias" in sd


def test_context_axis_raises():
    """A context axis of one rank (a world of one, an in-process store): the
    module built with ``cp_axis`` and bound to the mesh equals the unsharded
    one bit for bit, forward and gradients; a window whose frames the axis
    does not split raises."""
    _, _, tm = video_pair(4)
    cp = SpatioTemporalDiff(BASIS, cp_axis="context", **SMALL)
    cp.load_state_dict(tm.state_dict())
    x, t = (torch.as_tensor(a) for a in inputs(np.random.default_rng(0), 2, SMALL["frames"]))
    distributed_init(device="cpu")
    try:
        cp.bind_mesh(make_mesh((1,), ("context",), device_type="cpu"))
        assert cp.context.size == 1 and cp.context.group is not None
        outs = []
        for model in (tm, cp):
            model.train()
            for mod in model.modules():
                if isinstance(mod, torch.nn.Dropout):
                    mod.p = 0.0
            out = model(x, t)
            out.square().sum().backward()
            outs.append((out.detach(), {k: p.grad for k, p in model.named_parameters()}))
        assert torch.equal(outs[0][0], outs[1][0])
        assert all(torch.equal(g, outs[1][1][k]) for k, g in outs[0][1].items())
        with pytest.raises(ValueError, match="do not make one"):
            cp(x[:, :3], t)
    finally:
        distributed_shutdown()


@pytest.mark.parametrize("s,chunk,masked", [(10, 4, False), (10, 4, True), (6, 8, True)],
                         ids=["padded", "padded_masked", "one_chunk"])
def test_chunked_attention_matches_jax(rng, s, chunk, masked):
    q, k, v = (rng.normal(size=(2, 3, s, 8)).astype(np.float32) for _ in range(3))
    mask = (rng.uniform(size=(2, 1, s, s)) > 0.3).astype(np.float32) if masked else None
    want = jlayers.chunked_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                     None if mask is None else jnp.asarray(mask), chunk_size=chunk)
    got = layers.chunked_attention(torch.as_tensor(q), torch.as_tensor(k), torch.as_tensor(v),
                                   None if mask is None else torch.as_tensor(mask), chunk_size=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


def test_video_windows_and_synthetic_windows_equal_jax(rng):
    seqs3 = [rng.normal(size=(n, 17, 3)).astype(np.float32) for n in (11, 4, 20)]
    seqs2 = [rng.normal(size=(n, 17, 3, 5)).astype(np.float32) for n in (11, 4, 20)]
    acts = [[f"A{i}"] * n for i, n in enumerate((11, 4, 20))]
    for stride in (None, 3):
        ours = video.make_video_windows(seqs3, seqs2, acts, 5, stride)
        theirs = jvideo.make_video_windows(seqs3, seqs2, acts, 5, stride)
        for field in ("poses_3d", "poses_2d_gmm", "action_ids"):
            a, b = getattr(ours, field), getattr(theirs, field)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert ours.actions == theirs.actions and len(ours) == len(theirs)
    with pytest.raises(ValueError, match="long enough"):
        video.make_video_windows(seqs3, seqs2, acts, 30)
    ours, theirs = video.synthetic_video_dataset(6, 7, seed=3), jvideo.synthetic_video_dataset(6, 7, seed=3)
    assert ours.poses_3d.shape == (6, 7, 17, 3) and ours.actions == theirs.actions
    for field in ("poses_3d", "poses_2d_gmm", "action_ids"):
        np.testing.assert_array_equal(getattr(ours, field), getattr(theirs, field))
