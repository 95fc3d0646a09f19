"""The implicit family's fused paths on the CPU, where their kernels run as
their plain versions: the bare stack (kernel row 3) vs make_pallas_backbone_fn,
make_igcn_fn vs make_pallas_igcn, make_igcn_train_fn vs
make_pallas_igcn_train_fn over the JAX oracle stack, with the same explicit
masks.  The CUDA kernels themselves run only on the card; chip_smoke.py
holds them against these plain versions there."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffpose_tpu.ops import train_ref as jref
from diffpose_tpu.ops.pallas_denoiser import make_pallas_backbone_fn
from diffpose_tpu.ops.pallas_igcn import make_pallas_igcn
from diffpose_tpu.ops.pallas_igcn_train import make_pallas_igcn_train_fn
from diffpose_tpu_torch.models import convert
from diffpose_tpu_torch.models.igcn import bn_state
from diffpose_tpu_torch.ops import fused_denoiser as fd
from diffpose_tpu_torch.ops.fused_igcn import make_igcn_fn
from diffpose_tpu_torch.ops.fused_igcn_train import make_igcn_train_fn
from diffpose_tpu_torch.ops.philox import philox_masks
from test_torch_igcn import CFG, igcn_pair
from test_torch_models import BASIS
from test_torch_train_ref import grads_close, jax_masks, numpy_masks, to_port_masks

torch.set_num_threads(1)

B = 8
L, HID = CFG["num_layers"], CFG["hid_dim"]


def inputs(seed, batch=B):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(batch, 17, 5)).astype(np.float32)
    t = rng.integers(0, 51, size=batch).astype(np.float32)
    return rng, x, t


def test_backbone_plain_matches_pallas_backbone():
    _, variables, tm = igcn_pair(0)
    rng = np.random.default_rng(0)
    z = rng.normal(size=(B, 17, HID)).astype(np.float32)
    tp = rng.normal(size=(L, B, HID)).astype(np.float32)
    want = make_pallas_backbone_fn(BASIS, num_layers=L, num_heads=CFG["num_heads"], hid_dim=HID,
                                   block_b=B, interpret=True, precision=None)(
        variables["params"], jnp.asarray(z), jnp.asarray(tp))
    w = fd.prepare_weights(tm, device="cpu")
    fd.fused_backbone.launches = 0
    with torch.no_grad():
        got = fd.backbone_plain(w, torch.as_tensor(z), torch.as_tensor(tp))
        again = fd.fused_backbone(w, torch.as_tensor(z), torch.as_tensor(tp))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-5)
    assert torch.equal(again, got) and fd.fused_backbone.launches == 0


@pytest.mark.parametrize("solver,warm", [("anderson", True), ("damped", False)])
def test_make_igcn_fn_matches_pallas_igcn(solver, warm):
    # 4 iterations at most: the Pallas kernel runs interpreted
    jm, variables, tm = igcn_pair(1, solver=solver, max_iterations=4, min_iterations=2)
    rng, x, _ = inputs(1)
    t = np.full((B,), 12.0, np.float32)
    z0 = rng.normal(size=(B, 17, HID)).astype(np.float32)
    jfn = make_pallas_igcn(jm, variables["params"], variables["batch_stats"], block_b=B,
                           interpret=True, precision=None)
    fn = make_igcn_fn(tm, device="cpu")
    w = fd.prepare_weights(tm, device="cpu")
    start = {"z0": z0, "z0_weight": np.float32(0.3)} if warm else {}
    want, want_aux = jax.jit(jfn)(jnp.asarray(x), jnp.asarray(t),
                                  **{k: jnp.asarray(v) for k, v in start.items()})
    for bn in (tm, bn_state(tm)):
        got, aux = fn(w, bn, torch.as_tensor(x), torch.as_tensor(t),
                      **{k: torch.as_tensor(v) for k, v in start.items()})
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
        np.testing.assert_allclose(aux["fixed_point"].numpy(),
                                   np.asarray(want_aux["fixed_point"]), atol=1e-4)
        assert aux["iterations"] == int(want_aux["iterations"])
        if solver == "damped":
            np.testing.assert_allclose(float(aux["alpha"]), float(want_aux["alpha"]))


def _oracle_stack(w, h0, tp, masks):
    return jref.layers_forward(w, h0, tp, masks, basis=jnp.asarray(BASIS, jnp.float32),
                               num_layers=L, num_heads=CFG["num_heads"], hid_dim=HID)


def train_pair(seed, **solver):
    """The JAX oracle train fn and the port's fused train fn, same weights."""
    jm, variables, tm = igcn_pair(seed, **solver)
    jfn = make_pallas_igcn_train_fn(jm, stack_override=_oracle_stack)
    return jfn, variables, tm.train(), make_igcn_train_fn(tm, dropout="masks")


def test_train_fn_forward_and_batch_stats_match_jax():
    jfn, variables, tm, fn = train_pair(2, solver="anderson", max_iterations=3, min_iterations=3,
                                        anderson_m=3)
    rng, x, t = inputs(2)
    m = numpy_masks(rng, CFG, B)
    z0 = rng.normal(size=(B, 17, HID)).astype(np.float32)
    for warm in ((), (z0, np.float32(0.7))):
        want, want_aux, want_bs = jfn(variables["params"], variables["batch_stats"],
                                      jnp.asarray(x), jnp.asarray(t), jax_masks(m),
                                      *(jnp.asarray(v) for v in warm))
        got, aux, running = fn(torch.as_tensor(x), torch.as_tensor(t), to_port_masks(m),
                               *(torch.as_tensor(v) for v in warm))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-4)
        np.testing.assert_allclose(aux["fixed_point"].detach().numpy(),
                                   np.asarray(want_aux["fixed_point"]), atol=2e-4)
        assert int(aux["iterations"]) == int(want_aux["iterations"]) == 3
        np.testing.assert_allclose(running["running_mean"].numpy(), np.asarray(want_bs["bn_mean"]),
                                   atol=1e-5)
        np.testing.assert_allclose(running["running_var"].numpy(), np.asarray(want_bs["bn_var"]),
                                   atol=1e-5)
    # the function leaves the module's buffers alone: the step writes them
    assert torch.equal(tm.batch_norm.running_var,
                       torch.as_tensor(variables["batch_stats"]["bn_var"]))


def _grads(jfn, variables, tm, fn, x, t, m, e):
    def jloss(p):
        out, _, _ = jfn(p, variables["batch_stats"], jnp.asarray(x), jnp.asarray(t), jax_masks(m))
        return jnp.mean(jnp.sum((jnp.asarray(e) - out) ** 2, axis=(1, 2)))

    want = jax.grad(jloss)(variables["params"])
    out, _, _ = fn(torch.as_tensor(x), torch.as_tensor(t), to_port_masks(m))
    loss = ((torch.as_tensor(e) - out) ** 2).sum(dim=(1, 2)).mean()
    names = [k for k, _ in tm.named_parameters()]
    got = dict(zip(names, torch.autograd.grad(loss, list(tm.parameters()))))
    return convert.flax_igcn_from_state_dict(got, num_layers=L)["params"], want


@pytest.mark.parametrize("solver,iters", [("damped", 3), ("anderson", 2)])
def test_train_fn_gradients_match_jax(solver, iters):
    """Where the solve's derivative is well conditioned: the damped solver,
    Anderson before its history fills (tests/test_pallas_igcn_train.py:80-118)."""
    jfn, variables, tm, fn = train_pair(3, solver=solver, max_iterations=iters,
                                        min_iterations=iters, anderson_m=3)
    rng, x, t = inputs(3)
    got, want = _grads(jfn, variables, tm, fn, x, t, numpy_masks(rng, CFG, B),
                       rng.normal(size=(B, 17, 5)).astype(np.float32))
    grads_close(got, want)


def test_train_fn_gradients_finite_at_full_history():
    """Full Anderson history: the Gram solves amplify rounding in any two
    implementations; the gradients are finite and of one order."""
    jfn, variables, tm, fn = train_pair(4, solver="anderson", max_iterations=3, min_iterations=3,
                                        anderson_m=3)
    rng, x, t = inputs(4)
    got, want = _grads(jfn, variables, tm, fn, x, t, numpy_masks(rng, CFG, B),
                       rng.normal(size=(B, 17, 5)).astype(np.float32))
    norm = lambda tree: float(np.sqrt(sum(np.sum(np.asarray(v, np.float64) ** 2)
                                          for v in jax.tree_util.tree_leaves(tree))))
    ng, nw = norm(got), norm(want)
    assert np.isfinite(ng) and np.isfinite(nw)
    assert 0.2 < ng / nw < 5.0, (ng, nw)


def test_remat_gives_the_same_gradients():
    _, _, tm = igcn_pair(5, solver="damped", max_iterations=3, min_iterations=3)
    tm.train()
    rng, x, t = inputs(5)
    masks = to_port_masks(numpy_masks(rng, CFG, B))
    grads = []
    for remat in (False, True):
        out, _, _ = make_igcn_train_fn(tm, dropout="masks", remat=remat)(
            torch.as_tensor(x), torch.as_tensor(t), masks)
        grads.append(torch.autograd.grad(out.square().sum(), list(tm.parameters())))
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-5)


def test_seeded_train_fn_equals_masks_of_the_seed():
    _, _, tm = igcn_pair(6, solver="anderson", max_iterations=3, min_iterations=2)
    tm.train()
    _, x, t = inputs(6)
    seed = torch.tensor([123456789], dtype=torch.int32)
    masks = philox_masks(seed, num_layers=L, n_pts=17, batch=B, num_heads=CFG["num_heads"],
                         hid_dim=HID, device="cpu", dtype=torch.float32)
    a, aux_a, run_a = make_igcn_train_fn(tm, dropout="prng")(torch.as_tensor(x), torch.as_tensor(t),
                                                             seed)
    b, aux_b, run_b = make_igcn_train_fn(tm, dropout="masks")(torch.as_tensor(x),
                                                              torch.as_tensor(t), masks)
    assert torch.equal(a, b) and torch.equal(aux_a["fixed_point"], aux_b["fixed_point"])
    assert torch.equal(run_a["running_var"], run_b["running_var"])
    with pytest.raises(ValueError, match="takes a seed tensor"):
        make_igcn_train_fn(tm, dropout="prng")(torch.as_tensor(x), torch.as_tensor(t), masks)
