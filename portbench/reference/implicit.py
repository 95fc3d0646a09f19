"""The implicit family's evaluation batch, in plain PyTorch.

Written from the published implicit DiffPose (github.com/nwicakson/diffpose-nw:
``models/igcn.py`` ``IGCN`` and ``forward_anderson_optimized`` :293-438,
``runners/implicit_pose.py`` :523-531, ``configs/human36m_ipose.yml``), not
from the program.  ``eval_batch``: lift with GCNpose, root-centre, replicate
``test_times`` hypotheses, ONE fixed-point solve of the IGCN at the inference
timestep (no DDIM loop), hypothesis mean, root-centre, per-sample MPJPE and
P-MPJPE; in the dtype of the weights (the checks use float64) from the
benchmark's float32 weights and data.

The IGCN: ``z₀ = ChebConv_in(x)``, ``f(z) = BN(stack(z, temb))`` with ``stack``
GCNdiff's five GraAttenLayer + ResChebGC layers and ``BN`` the eval-mode
BatchNorm over the hidden channels (running buffers, eps 1e-5), the
Anderson solve below, and ``ChebConv_out(z*)``.

The Anderson solve (:func:`anderson`): ``f`` runs once on ``z₀``; each body
pushes ``z`` and its residual ``g = f(z) − z`` into histories of the newest
``m``; the first body takes the plain step ``z + β·g``; later bodies solve
``(ΔF ΔFᵀ + λI) α = −ΔF g`` over the differences ``ΔF_i = g_i − g`` of every
history row from the newest (whose own difference is zero, so its weight is
zero), normalise ``α`` to sum 1 (uniform over the history where the sum is
under 1e-10 in magnitude) and mix ``z ← Σ α_i (z_i + β g_i)``; a body whose
differences all vanish takes the plain step.  After each body ``f`` runs on
the new ``z`` and the relative update ``‖z_new − z‖ / (‖z‖ + 1e-8)`` over the
whole batch is the residual; the solve stops once it is under ``tol`` at a
body ``≥ min_iterations``, or after ``max_iterations`` bodies.

Since the newest row's weight is zero, the rule stalls: a body whose other
rows are copies of one iterate mixes that iterate's own step, which is the
current ``z``.  In exact arithmetic those bodies return ``z`` itself (at
m = 5: bodies 1–4 and 6–9; bodies 0, 5, 10, 15 take the plain step), so a
mixed iterate within float64 rounding of ``z`` (1e-9·‖z‖) is taken as ``z``;
without that, the rounding difference between two copies gets a weight of
about ``ε·‖ΔF‖²/λ`` and, at millions of values against λ = 0.1, the solve
follows the rounding within a few bodies.

Departures from the published code, each on purpose:

* The batch is solved whole: one iteration count for all B·test_times rows.
  The published runner cuts a batch into chunks by free memory
  (``implicit_pose.py:222-268``), each converging on its own; the program
  under test solves the batch whole, and so does this reference.
* The published attention runs in chunks (``process_attention_in_chunks``);
  chunking changes no value, so it is plain attention here.
* No warm start (the configuration's ``use_warm_start`` is false) and no
  memory hooks.
* The stall above is taken exactly where the published code, in float32,
  takes whatever its rounding gives; a stalled body does not run ``f`` again
  on the ``z`` it already ran it on.
"""

from __future__ import annotations

from typing import Callable, List, Tuple

import numpy as np
import torch

from portbench.reference import nets, protocol

BN_EPS = 1e-5
STALL = 1e-9          # a mixed iterate this close to z, relative to ‖z‖, is z (float64 rounding)


def batch_norm_eval(p: nets.Params, y: torch.Tensor) -> torch.Tensor:
    """Eval-mode BatchNorm1d over the last (hidden) axis of ``y``."""
    scale = p["batch_norm.weight"] / torch.sqrt(p["batch_norm.running_var"] + BN_EPS)
    return (y - p["batch_norm.running_mean"]) * scale + p["batch_norm.bias"]


def stack(p: nets.Params, z: torch.Tensor, temb: torch.Tensor, basis: torch.Tensor, *,
          layers: int, heads: int) -> torch.Tensor:
    """GCNdiff's layer stack without its input and output ChebConvs."""
    for i in range(layers):
        z = nets.gra_atten_layer(p, f"atten_layers.{i}", z, heads)
        z = nets.res_cheb(p, f"gconv_layers.{i}", z, basis, temb)
    return z


def anderson(f: Callable[[torch.Tensor], torch.Tensor], z: torch.Tensor, *, m: int, beta: float,
             lam: float, max_iterations: int, min_iterations: int,
             tol: float) -> Tuple[torch.Tensor, int, List[float]]:
    """The solve described in the module's docstring.  Returns ``(z*, bodies
    run, the residual after each body)``."""
    xs: List[torch.Tensor] = []
    gs: List[torch.Tensor] = []
    fz = f(z)
    residuals: List[float] = []
    for body in range(max_iterations):
        g = fz - z
        xs, gs = (xs + [z])[-m:], (gs + [g])[-m:]
        dF = torch.stack([(gi - g).reshape(-1) for gi in gs])
        if body == 0 or float(torch.linalg.vector_norm(dF)) < 1e-10:
            z_new = z + beta * g
        else:
            gram = dF @ dF.t() + lam * torch.eye(len(gs), dtype=z.dtype, device=z.device)
            alpha = torch.linalg.solve(gram, -(dF @ g.reshape(-1)))
            total = float(alpha.sum())
            if abs(total) > 1e-10:
                alpha = alpha / total
            else:
                alpha = torch.full_like(alpha, 1.0 / len(gs))
            z_new = sum(a * (xi + beta * gi) for a, xi, gi in zip(alpha, xs, gs))
            if float(torch.linalg.vector_norm(z_new - z)) <= STALL * float(torch.linalg.vector_norm(z)):
                z_new = z                      # the stall: f(z) is fz already
        if z_new is z:
            err = 0.0
        else:
            fz = f(z_new)
            err = float(torch.linalg.vector_norm(z_new - z) / (torch.linalg.vector_norm(z) + 1e-8))
        residuals.append(err)
        z = z_new
        if body + 1 >= min_iterations and err < tol:
            break
    return z, len(residuals), residuals


def igcn(p: nets.Params, x: torch.Tensor, t: torch.Tensor, basis: torch.Tensor, *, hid: int,
         layers: int, heads: int, solver: dict) -> Tuple[torch.Tensor, int, List[float]]:
    """The IGCN's ``ε̂`` for ``x [B, N, C]`` at timesteps ``t [B]``, with the
    solve's body count and residuals.  ``solver``: the configuration's
    ``implicit`` section (``anderson_m``, ``anderson_beta``,
    ``anderson_lambda``, ``max_iterations``, ``min_iterations``, ``tolerance``)."""
    temb = nets.timestep_embedding(t, hid)
    temb = nets.linear(p, "temb.dense.1", torch.nn.functional.silu(nets.linear(p, "temb.dense.0", temb)))
    z0 = nets.cheb_conv(p, "gconv_input", x, basis)
    z, bodies, residuals = anderson(
        lambda z: batch_norm_eval(p, stack(p, z, temb, basis, layers=layers, heads=heads)), z0,
        m=solver["anderson_m"], beta=solver["anderson_beta"], lam=solver["anderson_lambda"],
        max_iterations=solver["max_iterations"], min_iterations=solver["min_iterations"],
        tol=solver["tolerance"])
    return nets.cheb_conv(p, "gconv_output", z, basis), bodies, residuals


def eval_batch(diff: dict, pose: dict, data: dict, rows: np.ndarray, cfg: dict, device) -> dict:
    """``diff`` (the IGCN with its BatchNorm), ``pose``: float64 weights;
    ``data``: the split's arrays; ``rows``: the batch's dataset rows; ``cfg``:
    hid, layers, heads, test_times, t_infer, solver, loader_seed, basis.
    Returns pred ``[B, J, 3]``, p1, p2 ``[B]`` (metres) as numpy float64, the
    solve's ``iterations`` and its ``residuals`` after each body."""
    basis = torch.as_tensor(cfg["basis"], dtype=torch.float64, device=device)
    gmm = torch.as_tensor(data["poses_2d_gmm"][rows], device=device)
    p3 = torch.as_tensor(data["poses_3d"][rows], device=device).double()
    ids = torch.as_tensor(protocol.sample_ids(rows, seed=cfg["loader_seed"]), device=device)
    uv, _ = protocol.gmm_kernels(gmm, protocol.gmm_choice_per_sample(0, ids, gmm))
    uv = uv.double()
    arch = dict(layers=cfg["layers"], heads=cfg["heads"])
    xyz = nets.gcn_pose(pose, uv, basis, **arch)
    xyz = xyz - xyz[:, :1]
    x = torch.cat([uv, xyz], dim=-1).repeat(cfg["test_times"], 1, 1)
    t = torch.full((x.shape[0],), float(cfg["t_infer"]), dtype=x.dtype, device=device)
    out, bodies, residuals = igcn(diff, x, t, basis, hid=cfg["hid"], solver=cfg["solver"], **arch)
    out = out.reshape(cfg["test_times"], -1, *out.shape[1:]).mean(dim=0)
    pred = out[..., 2:] - out[:, :1, 2:]
    pred = pred.cpu().numpy()
    target = (p3 - p3[:, :1]).cpu().numpy()
    return dict(pred=pred, p1=protocol.mpjpe(pred, target), p2=protocol.p_mpjpe(pred, target),
                iterations=bodies, residuals=residuals)
