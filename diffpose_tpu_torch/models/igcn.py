"""IGCN — the implicit (deep-equilibrium) variant of the denoiser.

Reference ``models/igcn.py``; counterpart of ``diffpose_tpu/models/igcn.py``.
The same 5-layer GraFormer stack as :class:`~diffpose_tpu_torch.models.GCNDiff`,
but the forward solves a fixed point ``z* = f(z*)`` with
``f(z) = BatchNorm(stack(z))``, started from ``z₀ = gconv_input(x)``, and
projects ``z*`` out with ``gconv_output``.  Solvers: ``models/solvers.py``.

The ``state_dict`` keeps the reference names (``gconv_input``,
``temb.dense.{0,1}``, ``atten_layers.i``, ``gconv_layers.i``,
``gconv_output``, ``batch_norm.*``), so a reference IGCN ``.pth`` loads
strictly, and the fused paths (``ops/fused_denoiser.py:prepare_weights``)
take an IGCN as they take a GCNDiff.

What differs from ``torch.nn.BatchNorm1d`` and ``nn.Dropout``, on purpose:

* BatchNorm is computed by hand (``batch_norm`` holds its parameters and
  buffers only).  In training it normalises with the *biased* batch variance
  and moves the running buffers by that same biased variance, momentum 0.1,
  **once per forward**, from the statistics of the last solver iteration
  that counted (torch's module would use the unbiased variance and update
  once per iteration).  In eval it normalises with the buffers, eps 1e-5.
  ``num_batches_tracked`` is kept for the reference's names and not counted.
* Dropout masks are drawn **once per forward** and reused by every solver
  iteration: the flax module draws each site's mask once per traced call
  (``diffpose_tpu/ops/pallas_igcn_train.py:23-27``).  The training forward
  therefore runs the stack as ``ops/train_ref.layers_forward`` over one
  ``DropoutMasks``, not through ``nn.Dropout``.

There is no implicit-function-theorem gradient: the input enters only
through ``z₀``, so the exact fixed point does not depend on it; training
backprops through the finite solve (``diffpose_tpu/models/igcn.py:26-37``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch
import torch.utils.checkpoint
from torch import nn

from diffpose_tpu_torch.models.layers import (
    ChebGraphConv,
    GraAttenLayer,
    ResChebGCDiff,
    TimestepMLP,
)
from diffpose_tpu_torch.models.solvers import solve_anderson, solve_damped

BN_EPS = 1e-5


def bn_train(y: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor):
    """Train-mode BatchNorm over the flattened ``[B·J, C]`` features: returns
    ``(normalised y, (batch mean, biased batch variance))``."""
    flat = y.reshape(-1, y.shape[-1])
    mean = flat.mean(dim=0)
    var = flat.var(dim=0, unbiased=False)
    out = (flat - mean) * torch.rsqrt(var + BN_EPS) * scale + shift
    return out.reshape(y.shape), (mean, var)


def bn_eval(y: torch.Tensor, bn: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Eval-mode BatchNorm with the running buffers of :func:`bn_state`'s dict."""
    out = (y - bn["running_mean"]) * torch.rsqrt(bn["running_var"] + BN_EPS)
    return out * bn["weight"] + bn["bias"]


def bn_state(model: "IGCN") -> Dict[str, torch.Tensor]:
    """The BatchNorm's affine parameters and running buffers."""
    bn = model.batch_norm
    return {k: getattr(bn, k) for k in ("weight", "bias", "running_mean", "running_var")}


def warm_start(out: torch.Tensor, z0: Optional[torch.Tensor], z0_weight) -> torch.Tensor:
    """The solve's first iterate: ``gconv_input(x)``; ``z0`` verbatim; or the
    blend ``w·z0.detach() + (1−w)·gconv_input(x)`` (reference ``igcn.py:309-313``;
    ``w=0`` is exactly the cold start)."""
    if z0 is None:
        return out
    if z0_weight is None:
        return z0
    w = torch.as_tensor(z0_weight, dtype=out.dtype, device=out.device)
    return w * z0.detach() + (1 - w) * out


class IGCN(nn.Module):
    def __init__(self, basis, hid_dim: int = 96, coords_in: int = 5, coords_out: int = 5,
                 num_layers: int = 5, num_heads: int = 4, dropout_rate: float = 0.25,
                 n_pts: int = 17, *, solver: str = "anderson", max_iterations: int = 20,
                 min_iterations: int = 10, tolerance: float = 0.1, anderson_m: int = 5,
                 anderson_beta: float = 1.0, anderson_lambda: float = 0.1,
                 relaxation_alpha: float = 0.5, use_adaptive_alpha: bool = False,
                 min_alpha: float = 0.1, max_alpha: float = 0.9, bn_momentum: float = 0.1):
        super().__init__()
        if solver not in ("anderson", "damped"):
            raise ValueError(f"solver must be 'anderson' or 'damped', got {solver!r}")
        self.hid_dim, self.num_layers, self.num_heads, self.n_pts = (
            hid_dim, num_layers, num_heads, n_pts)
        self.solver, self.max_iterations, self.min_iterations = (
            solver, max_iterations, min_iterations)
        self.tolerance = tolerance
        self.anderson_m, self.anderson_beta, self.anderson_lambda = (
            anderson_m, anderson_beta, anderson_lambda)
        self.relaxation_alpha, self.use_adaptive_alpha = relaxation_alpha, use_adaptive_alpha
        self.min_alpha, self.max_alpha = min_alpha, max_alpha
        self.bn_momentum = bn_momentum
        emd_dim = 4 * hid_dim
        self.temb = TimestepMLP(hid_dim, emd_dim)
        self.gconv_input = ChebGraphConv(coords_in, hid_dim, basis)
        self.atten_layers = nn.ModuleList(
            [GraAttenLayer(hid_dim, num_heads, n_pts, dropout_rate) for _ in range(num_layers)])
        self.gconv_layers = nn.ModuleList(
            [ResChebGCDiff(hid_dim, hid_dim, basis, emd_dim, dropout_rate=0.1)
             for _ in range(num_layers)])
        self.gconv_output = ChebGraphConv(hid_dim, coords_out, basis)
        # parameters and buffers of the stabilising BatchNorm (igcn.py:95),
        # computed by bn_train / bn_eval
        self.batch_norm = nn.BatchNorm1d(hid_dim, momentum=bn_momentum)

    # ------------------------------------------------------------------

    def solve(self, f, z: torch.Tensor, tol, *, differentiable: bool):
        """This model's solver on ``f`` (``z → (f(z), stats)``) from ``z``:
        ``(z*, aux, stats)``, see ``models/solvers.py``."""
        if self.solver == "anderson":
            return solve_anderson(
                f, z, tol, m=self.anderson_m, beta=self.anderson_beta,
                lam=self.anderson_lambda, max_iterations=self.max_iterations,
                min_iterations=self.min_iterations, differentiable=differentiable)
        hid = self.hid_dim
        return solve_damped(
            f, z, tol, max_iterations=self.max_iterations,
            min_iterations=self.min_iterations, relaxation_alpha=self.relaxation_alpha,
            use_adaptive_alpha=self.use_adaptive_alpha, min_alpha=self.min_alpha,
            max_alpha=self.max_alpha, differentiable=differentiable,
            stats_init=(torch.zeros(hid, dtype=z.dtype, device=z.device),
                        torch.ones(hid, dtype=z.dtype, device=z.device)))

    def running_stats_after(self, stats):
        """The running buffers after one training forward with batch ``stats``
        (momentum ``bn_momentum``), detached; the buffers are not written."""
        m = self.bn_momentum
        bn = self.batch_norm
        return {"running_mean": ((1 - m) * bn.running_mean + m * stats[0]).detach(),
                "running_var": ((1 - m) * bn.running_var + m * stats[1]).detach()}

    def train_solve(self, w, x: torch.Tensor, t: torch.Tensor, stack_fn: Callable, drop, *,
                    z0=None, z0_weight=None, tolerance_override=None, remat: bool = False,
                    differentiable: bool = True):
        """The training forward over stacked weights ``w``
        (``ops/fused_denoiser.py:prepare_weights(..., differentiable=True)``):
        timestep projections, input ChebConv, warm start, the solve of
        ``f(z) = bn_train(stack_fn(w, z, tp, drop))`` (in the solver's
        fixed-count mode unless ``differentiable=False``), output ChebConv.

        ``stack_fn(w, z, tp, drop) → [B, N, H]`` is the layer stack in
        training mode with one dropout draw ``drop`` (masks or a seed) reused
        by every iteration.  ``remat`` recomputes each iteration's stack in
        the backward (``torch.utils.checkpoint``) instead of keeping it.
        Returns ``(out, aux, new running buffers)``; ``aux`` holds
        ``iterations``, ``residual``, ``fixed_point`` (and ``alpha``, damped).
        """
        from diffpose_tpu_torch.ops.fused_denoiser import _cheb, timestep_projections

        basis = w["basis"]
        tp = timestep_projections(w, t)
        z = warm_start(_cheb(x, w["win"], w["bin"], basis), z0, z0_weight)
        scale, shift = self.batch_norm.weight, self.batch_norm.bias

        def f(zz):
            return bn_train(stack_fn(w, zz, tp, drop), scale, shift)

        if remat:
            inner = f

            def f(zz):
                return torch.utils.checkpoint.checkpoint(inner, zz, use_reentrant=False)

        tol = self.tolerance if tolerance_override is None else tolerance_override
        z_star, aux, stats = self.solve(f, z, tol, differentiable=differentiable)
        out = _cheb(z_star, w["wout"], w["bout"], basis)
        return out, {**aux, "fixed_point": z_star}, self.running_stats_after(stats)

    # ------------------------------------------------------------------

    def _stack(self, z: torch.Tensor, temb: torch.Tensor, mask) -> torch.Tensor:
        for atten, res in zip(self.atten_layers, self.gconv_layers):
            z = res(atten(z, mask), temb)
        return z

    def forward(self, x: torch.Tensor, t: torch.Tensor, mask: Optional[torch.Tensor] = None, *,
                z0: Optional[torch.Tensor] = None, z0_weight=None,
                differentiable: Optional[bool] = None, tolerance_override=None,
                masks=None, generator: Optional[torch.Generator] = None):
        """Solve the fixed point and project out: ``(out [B, N, C_out], aux)``.

        ``aux`` holds ``iterations``, ``residual`` and ``fixed_point`` (the
        warm-start carry), plus ``alpha`` for the damped solver.  ``z0`` /
        ``z0_weight``: see :func:`warm_start`.  ``differentiable`` (default:
        ``self.training``) picks the solver's fixed-count mode.
        ``tolerance_override`` replaces ``tolerance`` (the progressive schedule).

        In training mode the stack runs over one set of dropout masks for
        the whole solve: ``masks`` (a ``DropoutMasks``) or, without, a draw
        from ``generator`` (default: the device's default generator); the
        running BatchNorm buffers move once.  ``mask`` (the attention mask)
        is honoured in eval mode; training takes the all-ones mask only.
        """
        from diffpose_tpu_torch.ops import fused_denoiser as fd
        from diffpose_tpu_torch.ops.train_ref import layers_forward, make_dropout_masks

        if differentiable is None:
            differentiable = self.training
        tol = self.tolerance if tolerance_override is None else tolerance_override

        if self.training:
            if mask is not None and not bool((mask != 0).all()):
                raise ValueError("IGCN training takes the all-ones attention mask only")
            if masks is None:
                if generator is None:
                    generator = (torch.default_generator if x.device.type == "cpu"
                                 else torch.cuda.default_generators[x.device.index or 0])
                masks = make_dropout_masks(
                    generator, num_layers=self.num_layers, n_pts=x.shape[1], batch=x.shape[0],
                    num_heads=self.num_heads, hid_dim=self.hid_dim, dtype=x.dtype)
            w = fd.prepare_weights(self, device=x.device, differentiable=True)
            out, aux, running = self.train_solve(
                w, x, t, lambda ww, z, tp, m: layers_forward(ww, z, tp, m), masks, z0=z0,
                z0_weight=z0_weight, tolerance_override=tolerance_override,
                differentiable=differentiable)
            with torch.no_grad():
                self.batch_norm.running_mean.copy_(running["running_mean"])
                self.batch_norm.running_var.copy_(running["running_var"])
            return out, aux

        temb = self.temb(t)
        bn = bn_state(self)
        z_star, aux, _ = self.solve(
            lambda z: (bn_eval(self._stack(z, temb, mask), bn), None),
            warm_start(self.gconv_input(x), z0, z0_weight), tol, differentiable=differentiable)
        return self.gconv_output(z_star), {**aux, "fixed_point": z_star}
