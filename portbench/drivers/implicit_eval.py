"""Implicit family, evaluation: ``ImplicitRunner.evaluate`` as
``cli.main_implicit --use_implicit`` builds it, over the cell's test split,
pass after pass.  Each batch: the lifter (kernel row 2), one Anderson solve
of the IGCN at the inference timestep over the batch's ``B × test_times``
rows (row 3 once before the loop and once a body), the hypothesis mean and
the errors.

The weights come from ``harness/weights.py`` as the frame cell's do, and the
IGCN's BatchNorm from the same draw by the rule the configuration's
``assumed`` states.

The check: the outputs of the sampled batches of every pass in the window
(the hypothesis mean's 3D pose, per-sample MPJPE and P-MPJPE) and each
batch's iteration count, against the plain reference
(``reference/implicit.py``) on the same weights and rows.  A batch whose
reference residual at the program's stopping body lies within 1% of the
tolerance is a tie: counted and printed, its count not held.
"""

from __future__ import annotations

import copy
import gc
import sys
from types import SimpleNamespace

import numpy as np
import torch

from portbench.harness import counts, data, evalloop, weights
from portbench.reference import frame as ref_frame
from portbench.reference import implicit as ref_implicit
from portbench.reference import protocol

TIE = 0.01           # a reference residual within 1% of the tolerance is a tie


class Capture(evalloop.Capture):
    """``evalloop.Capture`` that also records every batch's iteration count
    while recording (the count is a Python int: no synchronisation)."""

    def __init__(self, fn, per_pass, picks):
        super().__init__(fn, per_pass, picks)
        self.iterations = []

    def __call__(self, *args, **kwargs):
        out = super().__call__(*args, **kwargs)
        if self.recording:
            self.iterations.append(int(out[3]))
        return out


def batch_norm_rule(w: dict) -> dict:
    """The IGCN's BatchNorm from the draw ``harness/weights.py`` left in its
    buffers and gain (raw normal draws; the bias is already ``0.1 z``)."""
    w = dict(w)
    w["batch_norm.running_mean"] = 0.1 * w["batch_norm.running_mean"]
    w["batch_norm.running_var"] = 1.0 + 0.1 * w["batch_norm.running_var"].abs()
    w["batch_norm.weight"] = 1.0 + 0.1 * w["batch_norm.weight"]
    return w


def implicit_runner(ctx, test):
    """The runner as the implicit CLI builds it, its models holding the
    seed's weights.  Returns ``(runner, config, diff_weights, pose_weights)``."""
    from diffpose_tpu_torch.config import config_from_dict
    from diffpose_tpu_torch.data.pipeline import FlatDataset
    from diffpose_tpu_torch.train.implicit_runner import ImplicitRunner

    cfg = config_from_dict(copy.deepcopy(ctx.config["config"]))
    if "test_times" in ctx.cell:
        cfg.testing.test_times = int(ctx.cell["test_times"])
    r = ctx.config["runner"]
    runner = ImplicitRunner(
        cfg, use_implicit=True, seed=ctx.runner_seed, skip_type=r["skip_type"], eta=r["eta"],
        denoiser_impl=r["denoiser_impl"], train_impl=r["train_impl"],
        dropout_impl=r["dropout_impl"], kernel_precision=ctx.kernel_precision,
        eval_matmul_precision=r["matmul_precision"], train_matmul_precision=r["matmul_precision"],
        device=str(ctx.device))
    runner.create_diffusion_model(None)
    runner.create_pose_model(None)
    w_diff = batch_norm_rule(weights.make(weights.shapes_of(runner.model_diff), ctx.seed, ctx.device))
    w_pose = weights.make(weights.shapes_of(runner.model_pose), ctx.seed + 1, ctx.device)
    runner.model_diff.load_state_dict(w_diff)
    runner.model_pose.load_state_dict(w_pose)
    runner.set_data(None, FlatDataset(test["poses_3d"], test["poses_2d_gmm"], test["action_ids"],
                                      test["camera_para"], data.ACTIONS))
    return runner, cfg, w_diff, w_pose


def setup(ctx):
    test = data.frames(int(ctx.config["test_frames"]), ctx.seed, ctx.config["gmm_kernels"],
                       device=ctx.device)
    runner, cfg, w_diff, w_pose = implicit_runner(ctx, test)
    runner.evaluate(is_train=True)                       # warm-up: builds, loads, compiles
    (key, fn), = runner._eval_cache.items()
    batch = cfg.training.batch_size
    per_pass = -(-len(test["poses_3d"]) // batch)
    cap = Capture(fn, per_pass, evalloop.picks(ctx.seed, per_pass, ctx.cell["check"]["batches"]))
    runner._eval_cache[key] = cap
    m = cfg.model
    den = counts.net(m.hid_dim, m.num_layer, m.n_head, m.coords_dim[0], m.coords_dim[1], True)
    lift = counts.net(m.hid_dim, m.num_layer, m.n_head, 2, 3, False)
    imp = cfg.implicit
    return SimpleNamespace(
        ctx=ctx, runner=runner, cfg=cfg, capture=cap, test=test, w_diff=w_diff, w_pose=w_pose,
        per_pass=per_pass, kept=None, window_iterations=[],
        shapes=dict(family="implicit", batch=batch, test_times=cfg.testing.test_times,
                    rows=batch * cfg.testing.test_times, denoiser=den, lifter=lift,
                    anderson_m=imp.anderson_m, t_infer=cfg.testing.test_num_diffusion_timesteps))


def window(s, seconds):
    out = evalloop.run_window(s.runner, s.capture, seconds)
    s.attempted = out["units"]
    s.window_iterations = list(s.capture.iterations)
    return out


def profile(s, slice_):
    evalloop.profile_pass(s.runner, s.capture, slice_, s.ctx.cell["trace"]["start"])


def release(s):
    """Copy the kept outputs to the host and free the program's state."""
    s.kept = [(i, tuple(t.detach().cpu().double().numpy() for t in out[:3]) + (int(out[3]),))
              for i, out in s.capture.kept]
    s.runner = s.capture = None
    gc.collect()


def check(s):
    ctx, cfg = s.ctx, s.cfg
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    m, imp = cfg.model, cfg.implicit
    rc = dict(hid=m.hid_dim, layers=m.num_layer, heads=m.n_head, test_times=cfg.testing.test_times,
              t_infer=cfg.testing.test_num_diffusion_timesteps, loader_seed=ctx.runner_seed,
              basis=counts.cheb_basis(),
              solver=dict(anderson_m=imp.anderson_m, anderson_beta=imp.anderson_beta,
                          anderson_lambda=imp.anderson_lambda, max_iterations=imp.max_iterations,
                          min_iterations=imp.min_iterations, tolerance=imp.tolerance))
    diff, pose = ref_frame.to64(s.w_diff, ctx.device), ref_frame.to64(s.w_pose, ctx.device)
    batch, n = cfg.training.batch_size, len(s.test["poses_3d"])
    limits = ctx.cell["check"]["limits"]
    held = {k: v for k, v in limits.items() if k != "iters_gap"}
    refs = {}

    def reference(i):
        if i not in refs:
            refs[i] = ref_implicit.eval_batch(diff, pose, s.test, protocol.batch_rows(i, batch, n),
                                              rc, ctx.device)
        return refs[i]

    numbers, _ = evalloop.compare([(i, out[:3]) for i, out in s.kept], reference, held)
    gap, ties, failed = 0, 0, 0
    for i, out in s.kept:
        got, ref = out[3], reference(i)
        at = ref["residuals"][min(got, len(ref["residuals"])) - 1]
        tie = abs(at - imp.tolerance) <= TIE * imp.tolerance
        ties += tie
        if not tie:
            gap = max(gap, abs(got - ref["iterations"]))
        _, bad = evalloop.compare([(i, out[:3])], reference, held)
        failed += bool(bad) or (not tie and abs(got - ref["iterations"]) > limits["iters_gap"])
    if s.kept:
        numbers["iters_gap"] = float(gap)
    counts_seen = dict(zip(*(a.tolist() for a in np.unique(s.window_iterations, return_counts=True))))
    print(f"solver iterations a batch in the window: {counts_seen}; the reference's on the checked "
          f"batches: {sorted({r['iterations'] for r in refs.values()})}; ties {ties} of "
          f"{len(s.kept)}", file=sys.stderr, flush=True)
    return numbers, limits, s.attempted, failed
