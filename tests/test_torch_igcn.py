"""Port solvers, IGCN and its converters vs the JAX package
(diffpose_tpu/models/solvers.py, models/igcn.py, models/convert.py)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffpose_tpu.models import convert as jconvert
from diffpose_tpu.models import solvers as jsolvers
from diffpose_tpu.models.igcn import IGCN as JIGCN
from diffpose_tpu_torch.models import IGCN, convert, solvers
from diffpose_tpu_torch.models.igcn import bn_train
from test_torch_models import BASIS, CONFIGS, perturbed

torch.set_num_threads(1)

CFG = CONFIGS[0]                         # hid 32, 2 layers, 4 heads
SOLVE = dict(max_iterations=5, min_iterations=2, tolerance=0.05)   # tests/test_pallas_igcn.py


def igcn_pair(seed, cfg=CFG, **solver):
    """The flax IGCN and the port's, with the same perturbed weights and
    running statistics off their init."""
    kw = dict(SOLVE, **solver)
    jm = JIGCN(basis=BASIS, **cfg, **kw)
    v = jm.init({"params": jax.random.PRNGKey(seed)}, jnp.zeros((2, 17, 5)), jnp.zeros((2,)))
    rng = np.random.default_rng(seed)
    hid = cfg["hid_dim"]
    variables = {
        "params": perturbed(v["params"], seed),
        "batch_stats": {"bn_mean": (0.1 * rng.normal(size=hid)).astype(np.float32),
                        "bn_var": rng.uniform(0.5, 2.0, size=hid).astype(np.float32)}}
    tm = IGCN(BASIS, **cfg, **kw)
    tm.load_state_dict(convert.state_dict_from_flax_igcn(
        variables, num_layers=cfg["num_layers"], hid_dim=hid), strict=True)
    return jm, variables, tm.eval()


def contraction(seed, d=40):
    """A shared fixed-point problem ``z → tanh(A·z + b)`` with batch statistics."""
    rng = np.random.default_rng(seed)
    a = (rng.normal(size=(d, d)) * 0.9 / np.sqrt(d)).astype(np.float32)
    b = rng.normal(size=d).astype(np.float32)
    z0 = rng.normal(size=(4, d // 4)).astype(np.float32)

    def fj(z):
        y = jnp.tanh(z.reshape(-1) @ a + b).reshape(z.shape)
        return y, (jnp.mean(y), jnp.var(y))

    def ft(z):
        y = torch.tanh(z.reshape(-1) @ torch.as_tensor(a) + torch.as_tensor(b)).reshape(z.shape)
        return y, (y.mean(), y.var(unbiased=False))

    return fj, ft, z0


# (max_iterations, min_iterations, tol): early exit; no exit before the end;
# a loose tolerance.  m=3 < max_iterations, so the history fills and rolls.
RUNS = ((12, 3, 1e-3), (4, 4, 1e-3), (12, 3, 0.3))


@pytest.mark.parametrize("differentiable", [False, True], ids=["early_exit", "fixed_count"])
@pytest.mark.parametrize("solver", ["anderson", "damped"])
def test_solvers_match_jax(solver, differentiable):
    fj, ft, z0 = contraction(0)
    for mx, mn, tol in RUNS:
        if solver == "anderson":
            kw = dict(m=3, beta=1.0, lam=0.1, max_iterations=mx, min_iterations=mn,
                      differentiable=differentiable)
            zj, aj, sj = jsolvers.solve_anderson(fj, jnp.asarray(z0), jnp.float32(tol), **kw)
            zt, at, st = solvers.solve_anderson(ft, torch.as_tensor(z0), tol, **kw)
        else:
            kw = dict(max_iterations=mx, min_iterations=mn, use_adaptive_alpha=True,
                      differentiable=differentiable)
            zj, aj, sj = jsolvers.solve_damped(fj, jnp.asarray(z0), jnp.float32(tol),
                                               stats_init=(jnp.float32(0), jnp.float32(1)), **kw)
            zt, at, st = solvers.solve_damped(ft, torch.as_tensor(z0), tol,
                                              stats_init=(torch.tensor(0.0), torch.tensor(1.0)),
                                              **kw)
            np.testing.assert_allclose(float(at["alpha"]), float(aj["alpha"]), rtol=1e-6)
        assert int(at["iterations"]) == int(aj["iterations"]), (mx, mn, tol)
        assert isinstance(at["iterations"], torch.Tensor) == differentiable
        np.testing.assert_allclose(zt.numpy(), np.asarray(zj), atol=1e-5)
        np.testing.assert_allclose(float(at["residual"]), float(aj["residual"]), rtol=1e-4,
                                   atol=1e-7)
        for a, b in zip(st, sj):
            np.testing.assert_allclose(float(a), float(b), rtol=1e-5)


def test_early_exit_reads_the_host_only_from_min_iterations(monkeypatch):
    """One read of the convergence test per iteration, from the iteration
    where it can first succeed (the stopped Anderson solve reads each body's
    stall besides, just before); none in the fixed-count mode."""
    _, ft, z0 = contraction(1)
    reads = []
    real_bool = torch.Tensor.__bool__
    monkeypatch.setattr(torch.Tensor, "__bool__", lambda t: reads.append(1) or real_bool(t))
    _, aux, _ = solvers.solve_anderson(ft, torch.as_tensor(z0), 0.0, m=3, beta=1.0, lam=0.1,
                                       max_iterations=6, min_iterations=4)
    assert aux["iterations"] == 6 and len(reads) == 6 + 3
    reads.clear()
    solvers.solve_damped(ft, torch.as_tensor(z0), 0.0, max_iterations=6, min_iterations=4,
                         differentiable=True, stats_init=(torch.tensor(0.0), torch.tensor(1.0)))
    assert reads == []


@pytest.mark.parametrize("solver", ["anderson", "damped"])
def test_igcn_eval_matches_flax(rng, solver):
    jm, variables, tm = igcn_pair(0, solver=solver)
    x = rng.normal(size=(8, 17, 5)).astype(np.float32)
    t = np.full((8,), 12.0, np.float32)
    want, want_aux = jm.apply(variables, jnp.asarray(x), jnp.asarray(t), train=False,
                              differentiable=False)
    with torch.no_grad():
        got, aux = tm(torch.as_tensor(x), torch.as_tensor(t))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
    np.testing.assert_allclose(aux["fixed_point"].numpy(), np.asarray(want_aux["fixed_point"]),
                               atol=1e-4)
    assert aux["iterations"] == int(want_aux["iterations"])


def test_igcn_warm_start_and_tolerance_override_match_flax(rng):
    jm, variables, tm = igcn_pair(1)
    x = rng.normal(size=(8, 17, 5)).astype(np.float32)
    t = np.full((8,), 12.0, np.float32)
    z0 = rng.normal(size=(8, 17, CFG["hid_dim"])).astype(np.float32)
    for w, tol in ((0.3, None), (None, 0.5), (0.0, None)):
        kw = dict(z0=jnp.asarray(z0), z0_weight=None if w is None else jnp.float32(w),
                  tolerance_override=None if tol is None else jnp.float32(tol))
        want, want_aux = jm.apply(variables, jnp.asarray(x), jnp.asarray(t), train=False,
                                  differentiable=False, **kw)
        with torch.no_grad():
            got, aux = tm(torch.as_tensor(x), torch.as_tensor(t), z0=torch.as_tensor(z0),
                          z0_weight=w, tolerance_override=tol)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)
        assert aux["iterations"] == int(want_aux["iterations"])
    with torch.no_grad():
        cold, _ = tm(torch.as_tensor(x), torch.as_tensor(t))
        blend0, _ = tm(torch.as_tensor(x), torch.as_tensor(t), z0=torch.as_tensor(z0), z0_weight=0.0)
    assert torch.equal(cold, blend0)


def test_bn_train_matches_module_bn(rng):
    jm, variables, _ = igcn_pair(2)
    h = rng.normal(size=(6, 17, CFG["hid_dim"])).astype(np.float32) * 2 + 0.5
    y_j, (mean_j, var_j) = jm.apply(variables, jnp.asarray(h), True, method=JIGCN._bn)
    p = variables["params"]
    y, (mean, var) = bn_train(torch.as_tensor(h), torch.as_tensor(p["bn_scale"]),
                              torch.as_tensor(p["bn_bias"]))
    np.testing.assert_allclose(y.numpy(), np.asarray(y_j), atol=1e-5)
    np.testing.assert_allclose(mean.numpy(), np.asarray(mean_j), atol=1e-6)
    np.testing.assert_allclose(var.numpy(), np.asarray(var_j), atol=1e-6)


def test_train_forward_moves_running_stats_once_from_the_last_iteration(rng):
    """One momentum step per forward, with the biased batch variance of the
    last iteration that counted (a solve of 1 iteration against bn_train)."""
    _, _, tm = igcn_pair(3, solver="damped", max_iterations=1, min_iterations=1)
    before = {k: getattr(tm.batch_norm, k).clone() for k in ("running_mean", "running_var")}
    x = torch.as_tensor(rng.normal(size=(5, 17, 5)).astype(np.float32))
    t = torch.full((5,), 7.0)
    from diffpose_tpu_torch.ops import fused_denoiser as fd
    from diffpose_tpu_torch.ops.train_ref import layers_forward, make_dropout_masks

    masks = make_dropout_masks(torch.Generator().manual_seed(0), num_layers=2, n_pts=17, batch=5,
                               num_heads=4, hid_dim=CFG["hid_dim"])
    tm.train()
    tm(x, t, masks=masks)
    w = fd.prepare_weights(tm, device="cpu")
    with torch.no_grad():
        h0 = fd._cheb(x, w["win"], w["bin"], w["basis"])
        _, (mean, var) = bn_train(layers_forward(w, h0, fd.timestep_projections(w, t), masks),
                                  tm.batch_norm.weight, tm.batch_norm.bias)
    torch.testing.assert_close(tm.batch_norm.running_mean, 0.9 * before["running_mean"] + 0.1 * mean)
    torch.testing.assert_close(tm.batch_norm.running_var, 0.9 * before["running_var"] + 0.1 * var)
    assert int(tm.batch_norm.num_batches_tracked) == 0


def test_state_dict_round_trip(tmp_path):
    _, variables, tm = igcn_pair(4)
    want = jconvert.igcn_variables_to_torch_state(variables, num_layers=CFG["num_layers"],
                                                  prefix="", hid_dim=CFG["hid_dim"])
    sd = tm.state_dict()
    assert set(sd) == set(want)
    for k, v in want.items():
        np.testing.assert_array_equal(sd[k].numpy(), np.asarray(v), err_msg=k)
    back = convert.flax_igcn_from_state_dict(sd, num_layers=CFG["num_layers"])
    for tree in ("params", "batch_stats"):
        flat_w = jax.tree_util.tree_leaves_with_path(variables[tree])
        flat_g = jax.tree_util.tree_leaves_with_path(back[tree])
        assert [p for p, _ in flat_w] == [p for p, _ in flat_g]
        for (path, a), (_, b) in zip(flat_w, flat_g):
            np.testing.assert_array_equal(np.asarray(b), np.asarray(a), jax.tree_util.keystr(path))
    # a reference .pth (module. prefix) through the JAX package's writer
    path = str(tmp_path / "igcn.pth")
    jconvert.save_torch_states(path, jconvert.igcn_variables_to_torch_state(
        variables, num_layers=CFG["num_layers"], hid_dim=CFG["hid_dim"]))
    fresh = IGCN(BASIS, **CFG)
    fresh.load_state_dict(convert.load_torch_states(path)[0], strict=True)
    for k, v in fresh.state_dict().items():
        assert torch.equal(v, sd[k]), k
