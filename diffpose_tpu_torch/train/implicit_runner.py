"""The implicit-pose runner: the IGCN fixed-point model inside the train and
eval lifecycle of :class:`~diffpose_tpu_torch.train.trainer.DiffposeRunner`.

Capability parity with the reference ``runners/implicit_pose.py``;
counterpart of ``diffpose_tpu/train/implicit_runner.py``.
``use_implicit=False`` falls back to the frame runner, as the reference's
model-selection flag does (``implicit_pose.py:139-145``).

``train_impl="fused"`` runs every solver iteration's stack forward and
backward through the CUDA kernel pair (``ops/fused_igcn_train.py``), any
other value the module's training forward; ``denoiser_impl="fused"`` runs
the eval's lift and every solver iteration through the whole-network kernel
(``ops/fused_igcn.py``).  Checkpoints hold the BatchNorm's running buffers
with the parameters; the EMA shadow covers the parameters only.

Over a ``mesh`` the implicit steps are ``parallel/sharding.py``'s: each rank
solves its own slice (the eval's convergence, the Anderson history and the
warm-start carry are per rank), and the train step averages the BatchNorm
buffers it writes (``diffpose_tpu/train/implicit_runner.py:117-127,
233-241, 334-341``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from diffpose_tpu_torch.config import Config, ImplicitConfig
from diffpose_tpu_torch.models.igcn import IGCN
from diffpose_tpu_torch.parallel.sharding import (
    make_sharded_implicit_eval_step,
    make_sharded_implicit_train_step,
    make_sharded_implicit_train_sweep_step,
    mean_over,
)
from diffpose_tpu_torch.train.implicit_steps import (
    make_implicit_eval_step,
    make_implicit_train_step,
    make_implicit_train_sweep_step,
)
from diffpose_tpu_torch.train.state import TrainState
from diffpose_tpu_torch.train.trainer import DiffposeRunner


class ImplicitRunner(DiffposeRunner):
    def __init__(self, config: Config, *, use_implicit: bool = True, **kwargs):
        super().__init__(config, **kwargs)
        self.use_implicit = use_implicit
        self.fp_iterations: list = []
        self._raw_step = None

    @property
    def implicit(self) -> ImplicitConfig:
        return self.config.implicit or ImplicitConfig()

    def _tol_schedule(self):
        imp = self.implicit
        return ((imp.init_tol, imp.final_tol, imp.tol_decay_steps)
                if imp.use_progressive_tol else None)

    def create_diffusion_model(self, model_path: Optional[str] = None):
        if not self.use_implicit:
            return super().create_diffusion_model(model_path)
        m, imp = self.config.model, self.implicit
        self.model_diff = self._init_module(
            IGCN, m.coords_dim[0], m.coords_dim[1], model_path, "implicit",
            solver=imp.solver, max_iterations=imp.max_iterations,
            min_iterations=imp.min_iterations, tolerance=imp.tolerance,
            anderson_m=imp.anderson_m, anderson_beta=imp.anderson_beta,
            anderson_lambda=imp.anderson_lambda, use_adaptive_alpha=imp.use_adaptive_alpha,
            relaxation_alpha=imp.init_alpha, min_alpha=imp.min_alpha, max_alpha=imp.max_alpha)
        return self.model_diff

    # ------------------------------------------------------------------
    # Training
    # ------------------------------------------------------------------

    def train_tier(self) -> Optional[str]:
        """The frame runner's, except that the implicit family trains its
        stack on the kernels with ``--train_impl fused`` only (``plain``
        trains the module, as the JAX runner's non-Pallas step does)."""
        if not self.use_implicit:
            return super().train_tier()
        return self.kernel_precision if self.train_impl == "fused" else None

    def _build_train_step(self, steps_per_epoch: int):
        if not self.use_implicit:
            return super()._build_train_step(steps_per_epoch)
        optimizer = self._optimizer(steps_per_epoch)
        ema_mu = self.config.model.ema_rate if self.config.model.ema else None
        imp = self.implicit
        kwargs = dict(impl="fused" if self.train_impl == "fused" else "module", ema_mu=ema_mu,
                      use_warm_start=imp.use_warm_start, tol_schedule=self._tol_schedule(),
                      device=self.device, dropout=self.dropout_impl, tier=self.kernel_precision)
        if self.mesh is not None:
            self._raw_step = make_sharded_implicit_train_step(
                self.model_diff, optimizer, self.betas, self.mesh, **kwargs)
        else:
            self._raw_step = make_implicit_train_step(self.model_diff, optimizer, self.betas,
                                                      **kwargs)
        step = self._raw_step
        if imp.use_warm_start:
            step = self._wrap_warm_start(step, imp.warm_start_momentum)
        return optimizer, step

    def _build_sweep_fn(self, optimizer, n: int, base_step):
        """The ``n``-step sweep over the raw implicit step; with warm start the
        carry goes from step to step and from call to call."""
        if not self.use_implicit:
            return super()._build_sweep_fn(optimizer, n, base_step)
        imp = self.implicit
        kwargs = dict(sweep=n, base_step=self._raw_step, use_warm_start=imp.use_warm_start,
                      warm_start_momentum=imp.warm_start_momentum)
        if self.mesh is not None:
            fn = make_sharded_implicit_train_sweep_step(self.model_diff, optimizer, self.betas,
                                                        self.mesh, **kwargs)
        else:
            fn = make_implicit_train_sweep_step(self.model_diff, optimizer, self.betas, **kwargs)
        if imp.use_warm_start:
            fn = self._wrap_warm_start_sweep(fn, imp.warm_start_momentum)
        return fn

    def _zeros_like_carry(self, batch_size: int) -> torch.Tensor:
        m = self.config.model
        return torch.zeros((batch_size, m.n_pts, m.hid_dim), device=self.device)

    def _wrap_warm_start(self, raw_step, momentum: float):
        """Carry the previous batch's fixed point into the next step (the
        reference's ``last_fixed_point`` buffer, ``igcn.py:309-313``) at weight
        0 for the first step of an epoch and ``momentum`` after; ``.reset()``
        starts over, as ``reset_history`` does each epoch
        (``implicit_pose.py:319-320``)."""
        carry = {"z0": None, "w": 0.0}

        def step(state, batch, generator):
            if carry["z0"] is None:
                carry["z0"] = self._zeros_like_carry(batch["poses_3d"].shape[0])
            state, metrics = raw_step(state, batch, generator, carry["z0"], carry["w"])
            carry["z0"], carry["w"] = metrics.pop("fixed_point"), momentum
            return state, metrics

        def reset():
            carry["z0"], carry["w"] = None, 0.0

        step.reset = reset
        return step

    def _wrap_warm_start_sweep(self, raw_sweep, momentum: float):
        """The warm-start carry across sweep calls, one carry shared by the
        main and the tail sweep, so that it runs through the whole epoch."""
        carry = getattr(self, "_sweep_warm_carry", None)
        if carry is None:
            carry = self._sweep_warm_carry = {"z0": None, "w": 0.0}

        def step(state, data, idx, generator):
            if carry["z0"] is None:   # this rank's columns of the global index array
                carry["z0"] = self._zeros_like_carry(idx.shape[1] // self._data.size)
            state, metrics = raw_sweep(state, data, idx, generator, carry["z0"], carry["w"])
            carry["z0"], carry["w"] = metrics.pop("fixed_point"), momentum
            return state, metrics

        def reset():
            carry["z0"], carry["w"] = None, 0.0

        step.reset = reset
        return step

    # ------------------------------------------------------------------
    # Evaluation
    # ------------------------------------------------------------------

    def _get_eval_fn(self):
        """The direct-inference eval step: built once, reused every epoch."""
        if not self.use_implicit:
            return super()._get_eval_fn()
        warm = self.implicit.use_warm_start
        key = ("implicit_eval_fn", warm)
        fn = self._eval_cache.get(key)
        if fn is None:
            self._eval_builds += 1
            t_cfg = self.config.testing
            kwargs = dict(t_infer=t_cfg.test_num_diffusion_timesteps,
                          test_times=t_cfg.test_times, use_ema=self.use_ema_eval,
                          use_warm_start=warm, impl=self.denoiser_impl, device=self.device,
                          tier=self.kernel_precision)
            if self.mesh is not None:   # frames over data, every hypothesis on each rank
                fn = make_sharded_implicit_eval_step(self.model_diff, self.model_pose, self.mesh,
                                                     **kwargs)
            else:
                fn = make_implicit_eval_step(self.model_diff, self.model_pose, **kwargs)
            self._eval_cache[key] = fn
        return fn

    def _eval_hook(self, eval_fn, state: TrainState, prepared):
        """The frame runner's, plus the warm-start carry from batch to batch,
        reset at each evaluation (reference ``last_fixed_point``,
        ``implicit_pose.py:466-467``), and each batch's iteration count, the
        data ranks' mean over a mesh."""
        if not self.use_implicit:
            return super()._eval_hook(eval_fn, state, prepared)
        imp, test_times = self.implicit, self.config.testing.test_times
        self.fp_iterations = []
        z0, z0_weight = None, 0.0

        def run(local: dict):
            nonlocal z0, z0_weight
            if not imp.use_warm_start:
                return eval_fn(state, self.pose_params, local, self.generator, prepared=prepared)
            if z0 is None:
                z0 = self._zeros_like_carry(local["poses_3d"].shape[0] * test_times)
            out = eval_fn(state, self.pose_params, local, self.generator, z0, z0_weight,
                          prepared=prepared)
            z0, z0_weight = out[4], imp.warm_start_momentum
            return out

        def done(out):
            iters = out[3]
            if self.mesh is not None:
                iters = mean_over(torch.as_tensor(iters, dtype=torch.float32,
                                                  device=self.device).reshape(()), self._data)
            self.fp_iterations.append(float(iters))

        return run, done

    def _eval_note(self) -> str:
        if not self.use_implicit:
            return super()._eval_note()
        mean = float(np.mean(self.fp_iterations)) if self.fp_iterations else 0.0
        return f" | mean fp iterations: {mean:.1f}"
