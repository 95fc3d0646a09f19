"""The Anderson solve's one rule on the CPU (``models/solvers.py``): the ring
of history rows, the rule's corner cases (the uniform fallback, the plain
step where the differences vanish, the stalls) through the body that the
stopped mode runs (``ops/fused_anderson.py:fused_anderson_body``, its plain
version here), a stopped solve whose ring wraps twice against the
benchmark's float64 reference, the published rule's count at the
configuration's widths, which body each mode runs, and the stopped solve,
which evaluates the map only after a body that moved ``z``, against the
same solve evaluating it after every body."""

import numpy as np
import pytest
import torch

from diffpose_tpu_torch.graph import H36M_EDGES, cheb_basis_from_edges
from diffpose_tpu_torch.models import IGCN, solvers
from diffpose_tpu_torch.ops import fused_anderson as fa
from diffpose_tpu_torch.ops.fused_denoiser import prepare_weights
from diffpose_tpu_torch.ops.fused_igcn import make_igcn_fn
from portbench.reference import implicit as ref_implicit

torch.set_num_threads(1)

RULE = dict(m=5, beta=1.0, lam=0.1)   # configs/human36m_ipose.yml's implicit block


def test_push_writes_ring_slot_it_mod_m():
    """Body ``it`` writes ``z`` and ``f(z) − z`` into slot ``it mod m``;
    every other row stays where it was (nothing rolls)."""
    g = torch.Generator().manual_seed(1)
    X, F = torch.randn((5, 96), generator=g), torch.randn((5, 96), generator=g)
    z = torch.randn((32, 3), generator=g)
    fz = z + torch.randn((32, 3), generator=g)
    _, _, X2, F2, _ = solvers.anderson_body_plain(z, fz, X, F, 9, 1.0, 0.1)
    others = [i for i in range(5) if i != 9 % 5]
    assert torch.equal(X2[4], z.reshape(-1)) and torch.equal(F2[4], (fz - z).reshape(-1))
    assert torch.equal(X2[others], X[others]) and torch.equal(F2[others], F[others])


def rule_chain(seed, bodies, d=120):
    """The published rule's bodies on ``f(z) = tanh(a·z + b)`` from seeded
    ``z₀``: each body's inputs and outputs, in float32."""
    g = torch.Generator().manual_seed(seed)
    a, b, z = (torch.randn(d, generator=g) for _ in range(3))
    f = lambda v: torch.tanh(0.9 * a * v + b)
    X, F = torch.zeros((5, d)), torch.zeros((5, d))
    fz, out = f(z), []
    for it in range(bodies):
        z_new, err, X2, F2, flags = solvers.anderson_body_plain(z, fz, X, F, it, 1.0, 0.1)
        out.append((it, z, fz, X, F, z_new, err, flags))
        z, X, F = z_new, X2, F2
        fz = f(z)
    return out


@pytest.mark.parametrize("seed", [0, 1])
def test_stalled_bodies_return_z_bit_for_bit(seed):
    """At m=5 bodies 1–4, 6–9 and 11–14 stall: ``z`` back bit for bit, a
    residual of exactly 0; bodies 0, 5, 10 take the plain step."""
    for it, z, fz, X, F, z_new, err, (use_plain, stall) in rule_chain(seed, 15):
        if it % 5:
            assert bool(stall) and not bool(use_plain) and torch.equal(z_new, z) and float(err) == 0
        else:
            assert bool(use_plain) and not bool(stall) and float(err) > 0.1


@pytest.mark.parametrize("seed", [0, 1])
def test_vanishing_differences_take_the_plain_step(seed):
    """Bodies 5 and 10: every history row is a copy of one iterate, so
    ``‖ΔF‖`` is 0 and the body takes ``z + β·(f(z) − z)``, bit for bit."""
    for it, z, fz, X, F, z_new, err, (use_plain, stall) in rule_chain(seed, 11)[5::5]:
        assert bool(use_plain)
        assert torch.equal(z_new, z + 1.0 * (fz - z))
        beta = solvers.anderson_body_plain(z, fz, X, F, it, 0.6, 0.1)[0]
        assert torch.equal(beta, z + 0.6 * (fz - z))


def test_uniform_fallback_where_the_weights_sum_to_nought():
    """``f(z) = z + M·z + c`` with ``M c = −c/2 + u/2`` (``u ⟂ c``, ``|u| =
    |c|``) from ``z₀ = 0``: at body 1 the older row's weight is exactly 0, so
    the weights fall back to uniform over the two valid rows, ``z₁ + g₁/2``."""
    d = 6
    c, u = torch.eye(d, dtype=torch.float64)[:2]
    mat = torch.zeros((d, d), dtype=torch.float64)
    mat[:, 0] = -0.5 * c + 0.5 * u
    f = lambda z: z + (z.reshape(-1) @ mat.t() + c).reshape(z.shape)
    X, F = torch.zeros((5, d), dtype=torch.float64), torch.zeros((5, d), dtype=torch.float64)
    z0 = torch.zeros((2, 3), dtype=torch.float64)
    z1, _, X, F, _ = fa.fused_anderson_body(z0, f(z0), X, F, 0, 1.0, 0.1)
    z2, err, _, _, (use_plain, stall) = fa.fused_anderson_body(z1, f(z1), X, F, 1, 1.0, 0.1)
    assert not bool(use_plain) and not bool(stall)
    torch.testing.assert_close(z2, z1 + 0.5 * (f(z1) - z1), rtol=0, atol=1e-12)
    assert float(err) == pytest.approx(float((z2 - z1).norm() / (z1.norm() + 1e-8)), rel=1e-12)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_fifteen_bodies_stay_on_the_float64_rule(seed):
    """A stopped float32 solve of 15 bodies at m=5 (tolerance 0: every body
    runs; the ring wraps around twice) against the benchmark's float64
    reference of the rule (a list that drops its oldest row)."""
    rng = np.random.default_rng(seed)
    a, b = (torch.as_tensor(rng.normal(size=(32, 96)) * s) for s in (0.9, 1.0))
    z0 = torch.as_tensor(rng.normal(size=(32, 96)))
    kw = dict(m=5, beta=1.0, max_iterations=15, min_iterations=15)
    z, aux, _ = solvers.solve_anderson(lambda v: (torch.tanh(a.float() * v + b.float()), None),
                                       z0.float(), 0.0, lam=0.1, **kw)
    zr, bodies, residuals = ref_implicit.anderson(lambda v: torch.tanh(a * v + b), z0, lam=0.1,
                                                  tol=0.0, **kw)
    assert aux["iterations"] == bodies == 15
    assert float((z.double() - zr).norm() / zr.norm()) < 1e-6
    assert float(aux["residual"]) == residuals[-1] == 0.0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_published_rule_runs_ten_bodies_at_the_config_widths(seed):
    """The eval solve of configs/human36m_ipose.yml (m 5, β 1, λ 0.1, tol 0.1,
    10–20 bodies) on a seeded IGCN at its widths (hid 96, 5 layers, 4 heads,
    17 joints), 16 rows instead of 2,560: 10 bodies, row 3's plain version
    once before the loop and once after each of bodies 0 and 5, the two that
    move ``z`` (the others stall and keep ``f(z)``)."""
    gen = torch.Generator().manual_seed(seed)
    model = IGCN(cheb_basis_from_edges(17, H36M_EDGES)).eval()
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.05 * torch.randn(p.shape, generator=gen))
    calls = []

    def backbone(w, z, tp):
        calls.append(1)
        from diffpose_tpu_torch.ops.fused_denoiser import backbone_plain

        return backbone_plain(w, z, tp)

    fn = make_igcn_fn(model, device="cpu", backbone=backbone)
    x = torch.randn((16, 17, 5), generator=gen)
    out, aux = fn(prepare_weights(model, "cpu"), model, x, torch.full((16,), 12.0))
    assert aux["iterations"] == 10 and len(calls) == 3
    assert float(aux["residual"]) == 0.0 and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("differentiable", [False, True], ids=["stopped", "differentiable"])
def test_the_mode_picks_the_body(monkeypatch, differentiable):
    """The stopped mode runs every body through the wrapper (the kernels on a
    card); the differentiable mode runs the plain body under autograd."""
    calls = []
    monkeypatch.setattr(solvers, "fused_anderson_body",
                        lambda *a: calls.append(a[4]) or fa.fused_anderson_body(*a))
    z0 = torch.randn((4, 6), generator=torch.Generator().manual_seed(7))
    _, aux, _ = solvers.solve_anderson(lambda v: (torch.tanh(0.5 * v + 1.0), None), z0, 0.0,
                                       max_iterations=6, min_iterations=6,
                                       differentiable=differentiable, **RULE)
    assert int(aux["iterations"]) == 6
    assert calls == ([] if differentiable else list(range(6)))


def every_body_solve(f, z, tol, *, m, beta, lam, max_iterations, min_iterations,
                     differentiable=False):
    """The stopped Anderson solve with ``f`` evaluated after every body, the
    stalled ones too: ``(z*, {"iterations", "residual"}, stats)`` and the count
    of the bodies that moved ``z``."""
    assert not differentiable
    m = min(m, max_iterations)
    X, F = z.new_zeros((m, z.numel())), z.new_zeros((m, z.numel()))
    fz, stats = f(z)
    err, moving = torch.full((), float("inf"), dtype=z.dtype), 0
    for it in range(max_iterations):
        z, err, X, F, (_, stall) = solvers.anderson_body_plain(z, fz, X, F, it, beta, lam)
        moving += not bool(stall)
        fz, stats = f(z)
        if it + 1 >= min_iterations and bool(err < tol):
            return (z, {"iterations": it + 1, "residual": err}, stats), moving
    return (z, {"iterations": max_iterations, "residual": err}, stats), moving


def skipping_against_every_body(f, z, tol, **kw):
    """The stopped solve and :func:`every_body_solve` on one map and start:
    ``(the solve's results, every_body_solve's, the moving bodies, f's calls
    in the solve)``."""
    calls = []

    def counted(v):
        calls.append(1)
        return f(v)

    got = solvers.solve_anderson(counted, z, tol, **kw)
    want, moving = every_body_solve(f, z, tol, **kw)
    return got, want, moving, len(calls)


def igcn_solves(monkeypatch, path: str, tol: float):
    """One forward of a seeded tiny IGCN (m=5, 3–12 bodies) by ``path``, its
    solve held beside :func:`every_body_solve`."""
    from diffpose_tpu_torch.models import igcn

    held = []

    def solve(f, z, tol, **kw):
        held.append(skipping_against_every_body(f, z, tol, **kw))
        return held[-1][0]

    monkeypatch.setattr(igcn, "solve_anderson", solve)
    torch.manual_seed(0)
    model = IGCN(cheb_basis_from_edges(17, H36M_EDGES, 2).astype(np.float32), hid_dim=32,
                 num_layers=2, num_heads=4, max_iterations=12, min_iterations=3, tolerance=tol)
    gen = torch.Generator().manual_seed(1)
    x, t = torch.randn((8, 17, 5), generator=gen), torch.full((8,), 12.0)
    if path == "fused":
        model.eval()
        make_igcn_fn(model, device="cpu")(prepare_weights(model, "cpu"), model, x, t)
    elif path == "module":
        with torch.no_grad():
            model.eval()(x, t, differentiable=False)
    else:                       # the training forward's stopped solve: stats from z
        model.train()(x, t, differentiable=False, generator=gen)
    (res,) = held
    return res


def tanh_solve(m, beta):
    """A generic float64 map, ``f(z) = tanh(a·z + b)``, 12 bodies (tolerance 0)."""
    g = torch.Generator().manual_seed(11)
    a, b, z0 = (torch.randn((6, 20), generator=g, dtype=torch.float64) for _ in range(3))
    return skipping_against_every_body(lambda v: (torch.tanh(0.9 * a * v + b), None), z0, 0.0,
                                       m=m, beta=beta, lam=0.1, max_iterations=12,
                                       min_iterations=12)


@pytest.mark.parametrize("case", [
    ("fused", 0.1), ("fused", 0.0), ("module", 0.1), ("module", 0.0), ("train", 0.0),
    ("tanh", 5, 1.0), ("tanh", 1, 1.0), ("tanh", 1, 0.6)], ids=lambda c: "-".join(map(str, c)))
def test_skipping_solve_is_the_every_body_solve(monkeypatch, case):
    """The stopped solve evaluates ``f`` before the loop and after each body
    that moved ``z`` only, and returns what the solve that evaluates it after
    every body returns, bit for bit: ``z*``, ``iterations``, ``residual`` and
    the stats.  The tiny IGCN at m=5 (the fused CPU path, the module's eval,
    its training forward) and the tanh map at m=5 stall on every body but 0,
    5, 10; at m=1 every body takes the plain step and none stalls."""
    if case[0] == "tanh":
        got, want, moving, calls = tanh_solve(*case[1:])
        m = case[1]
    else:
        got, want, moving, calls = igcn_solves(monkeypatch, *case)
        m = 5
    (z, aux, stats), (zw, auxw, statsw) = got, want
    assert torch.equal(z, zw) and aux["iterations"] == auxw["iterations"]
    assert torch.equal(aux["residual"], auxw["residual"])
    assert (stats is None and statsw is None) or all(map(torch.equal, stats, statsw))
    iterations = aux["iterations"]
    assert iterations == (3 if case[-1] == 0.1 else 12)
    if m == 1:
        assert moving == iterations and calls == 1 + iterations
    else:
        assert moving == len(range(0, iterations, m)) < iterations
        assert calls == 1 + moving
