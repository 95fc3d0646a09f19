"""The benchmark's plain implicit reference (``portbench/reference/implicit.py``)
against the port on the CPU: the implicit eval step through the fused path
(its plain versions here) and the module, on seeded weights with the
benchmark's BatchNorm rule, at hid 32, B 8, two hypotheses; the Anderson
corner cases of ``models/solvers.py:solve_anderson`` against the reference's
solve on affine maps in float64; both solver modes on the rule at float32;
the gradient through a kept stall; and the reference loads nothing of the
program or of JAX."""

import subprocess
import sys

import numpy as np
import pytest
import torch

from diffpose_tpu_torch.models import GCNPose, IGCN
from diffpose_tpu_torch.models import solvers
from diffpose_tpu_torch.models.solvers import solve_anderson
from diffpose_tpu_torch.train.implicit_steps import make_implicit_eval_step
from diffpose_tpu_torch.train.state import TrainState
from portbench.harness import core, counts, data, weights
from portbench.reference import implicit as ref_implicit
from portbench.reference import protocol

torch.set_num_threads(1)

DRIVER = core.load_file(core.BENCH_DIR / "drivers" / "implicit_eval.py", "t_implicit_eval")
BASIS = counts.cheb_basis()
SOLVER = dict(anderson_m=5, anderson_beta=1.0, anderson_lambda=0.1, max_iterations=12,
              min_iterations=10, tolerance=0.1)
ARCH = dict(hid_dim=32, num_layers=2, num_heads=4)


def seeded(module, seed, rule=lambda w: w):
    w = rule(weights.make(weights.shapes_of(module), seed, "cpu"))
    module.load_state_dict(w)
    return module.eval(), {k: v.double() for k, v in w.items()}


@pytest.mark.parametrize("impl", ["fused", "module"])
def test_eval_step_matches_the_reference(impl):
    igcn, p = seeded(IGCN(BASIS.astype(np.float32), **ARCH,
                          max_iterations=SOLVER["max_iterations"],
                          min_iterations=SOLVER["min_iterations"]), 5, DRIVER.batch_norm_rule)
    lift, q = seeded(GCNPose(BASIS.astype(np.float32), **ARCH), 6)
    d = data.frames(8, 9)
    rows = np.arange(8)
    step = make_implicit_eval_step(igcn, lift, t_infer=12, test_times=2, impl=impl, device="cpu")
    batch = {"poses_3d": d["poses_3d"], "poses_2d_gmm": d["poses_2d_gmm"],
             "seeds": protocol.sample_ids(rows, seed=77)}
    p1, p2, pred, iterations = step(TrainState.create(igcn, None, None), lift, batch)
    cfg = dict(hid=32, layers=2, heads=4, test_times=2, t_infer=12, solver=SOLVER, loader_seed=77,
               basis=BASIS)
    ref = ref_implicit.eval_batch(p, q, d, rows, cfg, "cpu")
    assert iterations == ref["iterations"] == SOLVER["min_iterations"]
    assert np.max(np.abs(pred.numpy() - ref["pred"])) <= 1e-4 * np.max(np.abs(ref["pred"]))
    assert np.allclose(p1.numpy(), ref["p1"], rtol=1e-4)
    assert np.allclose(p2.numpy(), ref["p2"], rtol=1e-3, atol=1e-5)


def affine(g0, m0):
    """``f(z) = z + g(z)`` with ``g(z) = M·z + c`` on flattened ``z``: the
    program's callback and the reference's."""
    m0, g0 = torch.as_tensor(m0), torch.as_tensor(g0)

    def ref_f(z):
        return z + (z.reshape(-1) @ m0.t() + g0).reshape(z.shape)

    return (lambda z: (ref_f(z), None)), ref_f


def both(g0, m0, z0, **kw):
    prog_f, ref_f = affine(g0, m0)
    z0 = torch.as_tensor(z0, dtype=torch.float64)
    z, aux, _ = solve_anderson(prog_f, z0.clone(), kw["tol"], m=kw["m"], beta=kw["beta"], lam=0.1,
                               max_iterations=kw["max_iterations"],
                               min_iterations=kw["min_iterations"])
    zr, bodies, residuals = ref_implicit.anderson(ref_f, z0.clone(), lam=0.1, **kw)
    return z, aux, zr, bodies, residuals


def random_map(seed, d=12, scale=0.4):
    rng = np.random.default_rng(seed)
    return rng.normal(size=d), scale * rng.normal(size=(d, d)) / np.sqrt(d), rng.normal(size=(3, d // 3))


def test_first_body_is_the_plain_step():
    g0, m0, z0 = random_map(1)
    z, aux, zr, bodies, _ = both(g0, m0, z0, m=5, beta=0.7, max_iterations=1, min_iterations=1,
                                 tol=0.0)
    f = affine(g0, m0)[1]
    z0 = torch.as_tensor(z0)
    want = z0 + 0.7 * (f(z0) - z0)
    assert aux["iterations"] == bodies == 1
    assert torch.allclose(z, want, rtol=0, atol=1e-12) and torch.allclose(zr, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("m", [2, 3])
def test_history_rolls_after_m(m):
    """More bodies than the history holds, every one run (tol 0): the rows
    roll out oldest first, the stalls kept, the same iterate at the end."""
    g0, m0, z0 = random_map(2)
    z, aux, zr, bodies, residuals = both(g0, m0, z0, m=m, beta=1.0, max_iterations=9,
                                         min_iterations=9, tol=0.0)
    assert aux["iterations"] == bodies == 9
    assert torch.allclose(z, zr, rtol=1e-10, atol=1e-12)
    assert float(aux["residual"]) == pytest.approx(residuals[-1], rel=1e-9, abs=1e-15)


def test_uniform_fallback_where_the_weights_sum_to_nought():
    """``g(z) = M·z + c`` with ``M c = −c/2 + u/2`` (``u ⟂ c``, ``|u| = |c|``)
    from ``z₀ = 0``: at body 1 the weight of the older row is exactly
    nought, so both fall back to the uniform mix, ``z₁ + g₁/2``."""
    d = 6
    c, u = np.eye(d)[0], np.eye(d)[1]
    m0 = np.zeros((d, d))
    m0[:, 0] = -0.5 * c + 0.5 * u
    z, aux, zr, bodies, residuals = both(c, m0, np.zeros((2, d // 2)), m=5, beta=1.0,
                                         max_iterations=2, min_iterations=2, tol=0.0)
    g = affine(c, m0)[1]
    z1 = torch.as_tensor(c).reshape(2, d // 2)
    want = z1 + 0.5 * (g(z1) - z1)
    assert torch.allclose(z, want, atol=1e-12) and torch.allclose(zr, want, atol=1e-12)
    assert aux["iterations"] == bodies == 2


def test_stops_at_max_iterations():
    """Tolerance 0: no residual reads under it, not even a stall's 0, so
    both run every body and stop at ``max_iterations``."""
    g0, m0, z0 = random_map(3, scale=2.0)
    z, aux, zr, bodies, residuals = both(g0, m0, z0, m=5, beta=1.0, max_iterations=7,
                                         min_iterations=3, tol=0.0)
    assert aux["iterations"] == bodies == 7 and min(residuals) == 0.0
    assert torch.allclose(z, zr, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("differentiable", [False, True], ids=["eval", "train"])
def test_float32_solve_follows_the_rule(differentiable):
    """At 4,096 float32 values a float32 Gram solve already follows its
    rounding (0.71 away from the rule); both modes here stay on the
    reference's float64 solve, with its count."""
    rng = np.random.default_rng(6)
    a, b = (torch.as_tensor(rng.normal(size=(64, 64)) * s) for s in (0.9, 1.0))
    z0 = torch.as_tensor(rng.normal(size=(64, 64)))
    kw = dict(m=5, beta=1.0, max_iterations=20, min_iterations=10)
    z, aux, _ = solve_anderson(lambda z: (torch.tanh(a.float() * z + b.float()), None), z0.float(),
                               0.1, lam=0.1, differentiable=differentiable, **kw)
    zr, bodies, _ = ref_implicit.anderson(lambda z: torch.tanh(a * z + b), z0, lam=0.1, tol=0.1,
                                          **kw)
    assert int(aux["iterations"]) == bodies
    assert float((z.double() - zr).norm() / zr.norm()) < 1e-6


def test_keeping_z_on_a_stall_leaves_the_gradient(monkeypatch):
    """A stalled body's mixed iterate is the same function as ``z``: the
    gradient through the solve with the stall kept equals the one through
    the mixing (the stall test off)."""
    g0, m0, z0 = random_map(5)
    g0, z0 = torch.as_tensor(g0), torch.as_tensor(z0)

    def grad(stall_tol):
        monkeypatch.setattr(solvers, "STALL_TOL", stall_tol)
        mat = torch.as_tensor(m0).clone().requires_grad_()
        seen = []

        def f(z):
            seen.append(z.detach().clone())
            return z + (z.reshape(-1) @ mat.t() + g0).reshape(z.shape), None

        z, _, _ = solve_anderson(f, z0.clone(), 0.0, m=3, beta=1.0, lam=0.1, max_iterations=8,
                                 min_iterations=8, differentiable=True)
        return torch.autograd.grad(z.square().sum(), mat)[0], seen

    kept, seen = grad(solvers.STALL_TOL)
    mixed, _ = grad(-1.0)
    assert sum(torch.equal(a, b) for a, b in zip(seen, seen[1:])) >= 4   # the stalls
    torch.testing.assert_close(kept, mixed, rtol=1e-9, atol=1e-12)


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.reference.implicit\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'diffpose_tpu_torch', 'diffpose_tpu', 'jax', 'jaxlib', 'flax'}))\n") % str(core.ROOT)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip() == "[]"
