"""Fixed-point solvers of the implicit (IGCN) family: damped relaxation and
Anderson acceleration, shared by the module (:class:`~diffpose_tpu_torch.models.igcn.IGCN`),
the fused eval (``ops/fused_igcn.py``) and the fused training
(``ops/fused_igcn_train.py``).  Counterpart of ``diffpose_tpu/models/solvers.py``.

``f`` is a callback ``z → (f(z), stats)``; ``stats`` (``None`` or a tuple of
tensors, the BatchNorm batch statistics in training) is threaded through the
loop with done-masking, so the stats returned are those of the last
iteration that counted.

Two modes, as the JAX solvers have:

* ``differentiable=True`` runs exactly ``max_iterations`` bodies and masks
  the ones after convergence with ``torch.where`` (the JAX ``lax.scan``):
  no value goes to the host, and autograd runs through every body.
  ``iterations`` is then an ``int32`` tensor on the device.
* ``differentiable=False`` stops at convergence (the JAX ``while_loop``).
  Convergence can only be declared once ``it + 1 >= min_iterations``, so the
  damped solver's host reads the test from that body on, one
  synchronisation per body, and none before.  The Anderson solver's host
  reads every body's stall, and from ``min_iterations`` on its test with
  it: one synchronisation per body, after which a stalled body evaluates
  no ``f``.  ``iterations`` is then a Python int.

The convergence measure is the global relative update norm over the whole
batch, so every sample of a batch shares one iteration count.

Spans (``utils/profiling.py``): ``solver.f`` around each evaluation of
``f``, ``solver.mix`` around each body's update (Anderson: the history, the
Gram solve, the mixing, the stall and the relative update), ``solver.test``
around each host read of the convergence test (stopped Anderson: of the
body's stall and test).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from diffpose_tpu_torch.ops.fused_anderson import fused_anderson_body
from diffpose_tpu_torch.utils.profiling import span

Stats = Any
Callback = Callable[[torch.Tensor], Tuple[torch.Tensor, Stats]]

# Anderson: a mixed iterate within STALL_TOL·‖z‖ of z is the stall that the
# published rule makes in exact arithmetic (see :func:`solve_anderson`), and z
# is kept as it is.
STALL_TOL = 1e-5


def relative_residual(z: torch.Tensor, z_prev: torch.Tensor) -> torch.Tensor:
    """``‖z − z_prev‖ / (‖z_prev‖ + 1e-8)`` over all entries (reference ``igcn.py:265, 418``)."""
    return torch.linalg.vector_norm(z - z_prev) / (torch.linalg.vector_norm(z_prev) + 1e-8)


def _masked(done: Optional[torch.Tensor], old, new):
    """``new``, or ``old`` where ``done`` (``done=None``: no masking)."""
    if done is None or new is None:
        return new
    if isinstance(new, tuple):
        return tuple(_masked(done, o, n) for o, n in zip(old, new))
    return torch.where(done, old, new)


def _converged(it, err, tol, min_iterations):
    return (it + 1 >= min_iterations) & (err < tol)


def _read_test(err: torch.Tensor, tol) -> bool:
    """The host's read of the convergence test (it waits on the device)."""
    with span("solver.test"):
        return bool(err < tol)


def _read_body(stall: torch.Tensor, err: torch.Tensor, tol, test: bool) -> Tuple[bool, bool]:
    """The host's one read of a stopped Anderson body: ``(stalled, converged)``.
    The stall's read waits on the device for the body; the test, where
    ``test``, is read after it, from a drained queue."""
    with span("solver.test"):
        stalled = bool(stall)
        return stalled, test and bool(err < tol)


def solve_damped(
    f: Callback,
    z: torch.Tensor,
    tol,
    *,
    max_iterations: int,
    min_iterations: int,
    relaxation_alpha: float = 0.5,
    use_adaptive_alpha: bool = False,
    min_alpha: float = 0.1,
    max_alpha: float = 0.9,
    differentiable: bool = False,
    stats_init: Stats = None,
) -> Tuple[torch.Tensor, Dict[str, Any], Stats]:
    """Damped iteration ``z ← (1−α)·z + α·f(z)`` (reference ``igcn.py:250-282``).

    With ``use_adaptive_alpha``, α grows ×1.25 when the relative update
    shrank and halves when it grew, clamped to [min_alpha, max_alpha].
    Returns ``(z*, {"iterations", "residual", "alpha"}, stats)``.
    """
    dev, dtype = z.device, z.dtype
    err = torch.full((), float("inf"), dtype=dtype, device=dev)
    alpha = torch.full((), relaxation_alpha, dtype=dtype, device=dev)
    stats = stats_init
    if differentiable:
        it = torch.zeros((), dtype=torch.int32, device=dev)
        done = torch.zeros((), dtype=torch.bool, device=dev)
    else:
        it, done = 0, None

    for _ in range(max_iterations):
        with span("solver.f"):
            fz, new_stats = f(z)
        with span("solver.mix"):
            z_new = (1 - alpha) * z + alpha * fz
            new_err = relative_residual(z_new, z)
            if use_adaptive_alpha:
                grown = torch.clamp(alpha * 1.25, max=max_alpha)
                shrunk = torch.clamp(alpha * 0.5, min=min_alpha)
                alpha = _masked(done, alpha, torch.where(new_err < err, grown, shrunk))
        stats = _masked(done, stats, new_stats)
        if differentiable:
            new_done = done | _converged(it, new_err, tol, min_iterations)
            z = torch.where(done, z, z_new)
            err = torch.where(done, err, new_err)
            it = it + (~done).to(torch.int32)
            done = new_done
        else:
            z, err, it = z_new, new_err, it + 1
            if it >= min_iterations and _read_test(new_err, tol):
                break
    return z, {"iterations": it, "residual": err, "alpha": alpha}, stats


class _Gram64(torch.autograd.Function):
    """``(ΔF·ΔFᵀ, −ΔF·f)`` in float64, so that the Gram matrix keeps the λ
    added to it beside ``‖ΔF‖²``; the backward runs in the inputs' dtype, as
    every other gradient of the solve does."""

    @staticmethod
    def forward(ctx, dF: torch.Tensor, f: torch.Tensor):
        ctx.save_for_backward(dF, f)
        d64 = dF.double()
        return d64 @ d64.t(), -(d64 @ f.double())

    @staticmethod
    def backward(ctx, g_gram: torch.Tensor, g_rhs: torch.Tensor):
        dF, f = ctx.saved_tensors
        g_gram, g_rhs = g_gram.to(dF.dtype), g_rhs.to(dF.dtype)
        return (g_gram + g_gram.t()) @ dF - torch.outer(g_rhs, f), -(g_rhs @ dF)


def solve_anderson(
    f: Callback,
    z: torch.Tensor,
    tol,
    *,
    m: int,
    beta: float,
    lam: float,
    max_iterations: int,
    min_iterations: int,
    differentiable: bool = False,
) -> Tuple[torch.Tensor, Dict[str, Any], Stats]:
    """Anderson acceleration (reference ``igcn.py:293-438``) over a fixed
    ``[m, D]`` ring of history rows: body ``it`` writes slot ``it mod m``, so
    once the ring is full the newest row overwrites the oldest and nothing
    moves.  Rows not yet written are masked out of the differences, so the
    λ-regularised m×m Gram solve gives them zero weight; the weights do not
    depend on the rows' order.  The first body, and any body whose
    differences vanish, takes the plain update ``z + β·(f(z) − z)``.

    ``f`` runs once before the loop.  In the differentiable mode it runs
    after every body, so the stack runs ``1 + iterations`` times; as in the
    JAX solver, the history and the residual keep being written after
    convergence (only ``z``, ``f(z)``, the count and the stats are masked).
    In the stopped mode the host reads each body's stall (and, from
    ``min_iterations`` on, the convergence test with it), and ``f`` runs
    only after a body that moved ``z``: a stalled body returns ``z`` bit for
    bit, and ``f`` is a function of ``z`` alone, so ``f(z)`` and its stats
    stand.  The stack then runs 1 + the moving bodies' count times (3 in a
    solve of 10 bodies at m=5, below).

    The newest history row's difference is zero, so its weight is zero, and
    in exact arithmetic the published rule stalls: a body whose other rows
    are copies of one iterate returns that iterate's own step, the current
    ``z``, again (at m=5, bodies 1–4 and 6–9 return ``z`` unchanged and
    bodies 0, 5, 10, 15 take the plain step).  A rounding-level difference
    between two such copies gets a weight of about ``ε·‖ΔF‖²/λ``, which at the
    published batch (millions of values, λ = 0.1) is of order one in
    float32, and the λ of the Gram matrix is lost beside ``‖ΔF‖²``: the
    solve then follows the rounding, not the rule.  So both modes solve the
    Gram system in float64 and keep ``z`` where the mixed iterate lies within
    ``STALL_TOL·‖z‖`` of it, as the rule does in exact arithmetic.  A stalled
    body's mixed iterate is, in exact arithmetic, the same function of the
    inputs as ``z``, so keeping ``z`` leaves the gradient as it is.  (The JAX
    solver mixes in float32; at small batches, where the rounding stays
    small, the two agree.)

    One rule, two implementations of a body: the differentiable mode runs
    :func:`anderson_body_plain` under autograd; the stopped mode runs
    ``ops/fused_anderson.py:fused_anderson_body``, the CUDA kernels for
    CUDA tensors and :func:`anderson_body_plain` for CPU tensors.
    Returns ``(z*, {"iterations", "residual"}, stats)``.
    """
    m = min(m, max_iterations)
    dev, dtype = z.device, z.dtype
    d = z.numel()
    X = torch.zeros((m, d), dtype=dtype, device=dev)
    F = torch.zeros((m, d), dtype=dtype, device=dev)
    with span("solver.f"):
        fz, stats = f(z)
    err = torch.full((), float("inf"), dtype=dtype, device=dev)
    if not differentiable:
        it = 0
        for _ in range(max_iterations):
            with span("solver.mix"):
                z, err, X, F, (_, stall) = fused_anderson_body(z, fz, X, F, it, beta, lam)
            it += 1
            stalled, converged = _read_body(stall, err, tol, it >= min_iterations)
            if not stalled:
                with span("solver.f"):
                    fz, stats = f(z)
            if converged:
                break
        return z, {"iterations": it, "residual": err}, stats

    it = torch.zeros((), dtype=torch.int32, device=dev)
    done = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(max_iterations):
        with span("solver.mix"):
            z_new, err, X, F, _ = anderson_body_plain(z, fz, X, F, it, beta, lam)
        with span("solver.f"):
            fz_new, new_stats = f(z_new)
        stats = _masked(done, stats, new_stats)
        new_done = done | _converged(it, err, tol, min_iterations)
        z = torch.where(done, z, z_new)
        fz = torch.where(done, fz, fz_new)
        it = it + (~done).to(torch.int32)
        done = new_done
    return z, {"iterations": it, "residual": err}, stats


def anderson_body_plain(z, fz, X, F, it, beta: float, lam: float):
    """One body of :func:`solve_anderson`: push ``z`` and its residual
    ``f(z) − z`` into ring slot ``it mod m`` of the histories ``X``, ``F``
    ``[m, D]``, solve the λ-regularised Gram system in float64, mix, keep
    ``z`` on a stall, and measure the relative update.  ``it`` is a Python
    int (stopped mode) or a device tensor (differentiable mode, under
    autograd).  The plain version of ``ops/fused_anderson.py``'s kernels.
    Returns ``(z_new, err, X, F, (use_plain, stall))``; ``err`` is
    ``relative_residual(z_new, z)``."""
    differentiable = isinstance(it, torch.Tensor)
    dtype, m = z.dtype, X.shape[0]
    slots = torch.arange(m, device=z.device)
    residual = fz - z
    slot = it % m
    at = (slots == slot)[:, None]      # the push: nothing rolls
    X = torch.where(at, z.reshape(-1)[None], X)
    F = torch.where(at, residual.reshape(-1)[None], F)
    count = (torch.clamp(it + 1, max=m) if differentiable else min(it + 1, m))
    valid = (slots < count).to(dtype)
    f_new = (F.index_select(0, slot.reshape(1).long()) if differentiable
             else F[slot:slot + 1])
    dF = (F - f_new) * valid[:, None]

    gram, rhs = _Gram64.apply(dF, f_new[0])
    eye = lam * torch.eye(m, dtype=torch.float64, device=z.device)
    weights = torch.linalg.solve_ex(gram + eye, rhs)[0]
    w_sum = weights.sum()
    sum_ok = w_sum.abs() > 1e-10
    # The unselected branch of a where() must not be NaN (0/0), or its
    # gradient poisons the whole backward through the loop.
    safe_sum = torch.where(sum_ok, w_sum, torch.ones_like(w_sum))
    weights = torch.where(sum_ok, weights / safe_sum, valid.to(eye.dtype) / count).to(dtype)
    z_and = (weights @ X).reshape(z.shape) + beta * (weights @ F).reshape(z.shape)
    use_plain = (it < 1) | (torch.linalg.vector_norm(dF) < 1e-10)
    z_new = torch.where(use_plain, z + beta * residual, z_and)
    step, norm = torch.linalg.vector_norm(z_new - z), torch.linalg.vector_norm(z)
    stall = step <= STALL_TOL * norm
    # relative_residual of the kept iterate: 0 on a stall
    err = torch.where(stall, torch.zeros_like(step), step / (norm + 1e-8))
    return torch.where(stall, z, z_new), err, X, F, (use_plain, stall)
