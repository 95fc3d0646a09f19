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
  host reads the test from that body on, one synchronisation per body, and
  none before.  ``iterations`` is then a Python int.

The convergence measure is the global relative update norm over the whole
batch, so every sample of a batch shares one iteration count.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

Stats = Any
Callback = Callable[[torch.Tensor], Tuple[torch.Tensor, Stats]]


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
        fz, new_stats = f(z)
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
            if it >= min_iterations and bool(new_err < tol):
                break
    return z, {"iterations": it, "residual": err, "alpha": alpha}, stats


def _push(hist: torch.Tensor, row: torch.Tensor, it, m: int) -> torch.Tensor:
    """Write ``row`` into the history's slot ``min(it, m−1)``, after rolling
    the oldest row out once the history is full (``it >= m``)."""
    slots = torch.arange(m, device=hist.device)
    if isinstance(it, int):
        hist = hist.roll(-1, 0) if it >= m else hist
        slot = min(it, m - 1)
    else:
        hist = torch.where(it >= m, hist.roll(-1, 0), hist)
        slot = torch.clamp(it, max=m - 1)
    return torch.where((slots == slot)[:, None], row[None], hist)


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
    ``[m, D]`` history: slots fill 0..m−1, then the oldest rolls out.  Rows
    not yet written are masked out of the differences, so the λ-regularised
    m×m Gram solve gives them zero weight.  The first body, and any body
    whose differences vanish, takes the plain update ``z + β·(f(z) − z)``.

    ``f`` runs once before the loop, so the stack runs ``1 + iterations``
    times.  As in the JAX solver, in the differentiable mode the history and
    the residual keep being written after convergence (only ``z``, ``f(z)``,
    the count and the stats are masked).
    Returns ``(z*, {"iterations", "residual"}, stats)``.
    """
    m = min(m, max_iterations)
    dev, dtype = z.device, z.dtype
    d = z.numel()
    X = torch.zeros((m, d), dtype=dtype, device=dev)
    F = torch.zeros((m, d), dtype=dtype, device=dev)
    fz, stats = f(z)
    eye = lam * torch.eye(m, dtype=dtype, device=dev)
    slots = torch.arange(m, device=dev)
    err = torch.full((), float("inf"), dtype=dtype, device=dev)
    if differentiable:
        it = torch.zeros((), dtype=torch.int32, device=dev)
        done = torch.zeros((), dtype=torch.bool, device=dev)
    else:
        it, done = 0, None

    for _ in range(max_iterations):
        residual = fz - z
        X = _push(X, z.reshape(-1), it, m)
        F = _push(F, residual.reshape(-1), it, m)
        count = (torch.clamp(it + 1, max=m) if differentiable else min(it + 1, m))
        valid = (slots < count).to(dtype)
        newest = count - 1
        f_new = (F.index_select(0, newest.reshape(1).long()) if differentiable
                 else F[newest:newest + 1])
        dF = (F - f_new) * valid[:, None]

        gram = dF @ dF.t() + eye
        rhs = -(dF @ f_new[0])
        weights = torch.linalg.solve_ex(gram, rhs)[0]
        w_sum = weights.sum()
        sum_ok = w_sum.abs() > 1e-10
        # The unselected branch of a where() must not be NaN (0/0), or its
        # gradient poisons the whole backward through the loop.
        safe_sum = torch.where(sum_ok, w_sum, torch.ones_like(w_sum))
        weights = torch.where(sum_ok, weights / safe_sum, valid / count)
        z_and = (weights @ X).reshape(z.shape) + beta * (weights @ F).reshape(z.shape)
        use_plain = (it < 1) | (torch.linalg.vector_norm(dF) < 1e-10)
        z_new = torch.where(use_plain, z + beta * residual, z_and)

        fz_new, new_stats = f(z_new)
        err = relative_residual(z_new, z)
        stats = _masked(done, stats, new_stats)
        if differentiable:
            new_done = done | _converged(it, err, tol, min_iterations)
            z = torch.where(done, z, z_new)
            fz = torch.where(done, fz, fz_new)
            it = it + (~done).to(torch.int32)
            done = new_done
        else:
            z, fz, it = z_new, fz_new, it + 1
            if it >= min_iterations and bool(err < tol):
                break
    return z, {"iterations": it, "residual": err}, stats
