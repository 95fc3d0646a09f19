"""Frame family, evaluation: ``DiffposeRunner.evaluate`` as ``cli.main_frame``
builds it, over the cell's test split, pass after pass.

The check: the outputs of the sampled batches of every pass in the window
(the hypothesis mean's 3D pose, per-sample MPJPE and P-MPJPE) against the
plain reference on the same weights and rows: the lifter, each DDIM step's
denoiser and the mean are all inside the pose compared.
"""

from __future__ import annotations

import gc
from types import SimpleNamespace

import torch

from portbench.harness import counts, data, evalloop
from portbench.harness.runners import frame_runner
from portbench.reference import frame as ref_frame
from portbench.reference import protocol


def nets(cfg):
    m = cfg.model
    den = counts.net(m.hid_dim, m.num_layer, m.n_head, m.coords_dim[0], m.coords_dim[1], True)
    lift = counts.net(m.hid_dim, m.num_layer, m.n_head, 2, 3, False)
    return den, lift


def setup(ctx):
    test = data.frames(int(ctx.config["test_frames"]), ctx.seed, ctx.config["gmm_kernels"],
                        device=ctx.device)
    runner, cfg, w_diff, w_pose = frame_runner(ctx, test)
    runner.evaluate(is_train=True)                       # warm-up: builds, loads, compiles
    (key, fn), = runner._eval_cache.items()
    batch = cfg.training.batch_size
    per_pass = -(-len(test["poses_3d"]) // batch)
    cap = evalloop.Capture(fn, per_pass, evalloop.picks(ctx.seed, per_pass, ctx.cell["check"]["batches"]))
    runner._eval_cache[key] = cap
    seq = protocol.uniform_seq(cfg.testing.test_timesteps, cfg.testing.test_num_diffusion_timesteps)
    den, lift = nets(cfg)
    return SimpleNamespace(
        ctx=ctx, runner=runner, cfg=cfg, capture=cap, test=test, w_diff=w_diff, w_pose=w_pose,
        per_pass=per_pass, kept=None,
        shapes=dict(family="frame", batch=batch, test_times=cfg.testing.test_times,
                    ddim_steps=len(seq), denoiser=den, lifter=lift, seq=seq))


def window(s, seconds):
    out = evalloop.run_window(s.runner, s.capture, seconds)
    s.attempted = out["units"]
    return out


def profile(s, slice_):
    evalloop.profile_pass(s.runner, s.capture, slice_, s.ctx.cell["trace"]["start"])


def release(s):
    """Copy the kept outputs to the host and free the program's state."""
    s.kept = [(i, tuple(t.detach().cpu().double().numpy() for t in out))
              for i, out in s.capture.kept]
    s.runner = s.capture = None
    gc.collect()


def check(s):
    ctx, cfg = s.ctx, s.cfg
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    d = ctx.config["config"]["diffusion"]
    rc = dict(hid=cfg.model.hid_dim, layers=cfg.model.num_layer, heads=cfg.model.n_head,
              test_times=cfg.testing.test_times, seq=s.shapes["seq"],
              betas=protocol.linear_betas(d["beta_start"], d["beta_end"], d["num_diffusion_timesteps"]),
              loader_seed=ctx.runner_seed, basis=counts.cheb_basis())
    diff, pose = ref_frame.to64(s.w_diff, ctx.device), ref_frame.to64(s.w_pose, ctx.device)
    batch, n = cfg.training.batch_size, len(s.test["poses_3d"])
    limits = ctx.cell["check"]["limits"]
    numbers, failed = evalloop.compare(
        s.kept, lambda i: ref_frame.eval_batch(diff, pose, s.test, protocol.batch_rows(i, batch, n), rc, ctx.device), limits)
    return numbers, limits, s.attempted, failed
