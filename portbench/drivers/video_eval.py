"""Video family, evaluation: ``VideoRunner.evaluate`` as ``cli.main_video``
builds it with the MixSTE denoiser (``diffpose_tpu_torch/models/mixste.py``,
the configuration's ``mixste`` section), over the cell's test windows, pass
after pass.  Each batch: the per-frame GMM draw of the 2D input, a zero xyz
start, DDIM over every hypothesis of every window (each step one forward of
16 transformer blocks), the hypothesis mean and the per-frame errors, on
the module path at the configuration's matmul precision.

The driver imports the MixSTE class at set-up, so a program without it
exits at once.  The weights come from ``harness/weights.py``; its rule
leaves LayerNorm gains (1-D ``weight``) raw normal draws, so they take
``1 + 0.1 z`` here.  ``--control`` runs the products at one TF32 pass
(``--matmul_precision default``): the module path has no kernel tier.

The check: the outputs of the sampled batches of every pass in the window
(the hypothesis mean's pose, per-frame MPJPE and P-MPJPE) against the plain
float64 reference (``reference/mixste.py``) on the same weights and windows.
"""

from __future__ import annotations

import copy
import gc
import sys
import time
from types import SimpleNamespace

import torch

from portbench.harness import counts_video, evalloop, weights, windows
from portbench.harness.data import ACTIONS
from portbench.reference import mixste as ref_mixste
from portbench.reference import protocol
from portbench.reference.frame import to64

REFERENCE_WINDOWS = 5      # window-hypotheses the reference computes at once
TIMED_CALLS = 20           # calls of the block timers (temporal_ms.video, spatial_ms.video)


def gains(w: dict) -> dict:
    """LayerNorm gains ``1 + 0.1 z`` from the raw draws ``weights.make`` left."""
    return {k: 1.0 + 0.1 * v if v.ndim == 1 and k.endswith("weight") else v for k, v in w.items()}


def video_runner(ctx, test):
    """The runner as the video CLI builds it, its model holding the seed's
    weights.  Returns ``(runner, config, weights)``."""
    from diffpose_tpu_torch.config import config_from_dict
    from diffpose_tpu_torch.data.video import VideoDataset
    from diffpose_tpu_torch.train.video_runner import VideoRunner

    cfg = config_from_dict(copy.deepcopy(ctx.config["config"]))
    cfg.testing.test_times = int(ctx.cell["test_times"])
    r = ctx.config["runner"]
    control = ctx.kernel_precision != r["kernel_precision"]
    matmul = "default" if control else r["matmul_precision"]
    runner = VideoRunner(
        cfg, seed=ctx.runner_seed, skip_type=r["skip_type"], eta=r["eta"],
        denoiser_impl=r["denoiser_impl"], train_impl=r["train_impl"],
        dropout_impl=r["dropout_impl"], kernel_precision=r["kernel_precision"],
        eval_matmul_precision=matmul, train_matmul_precision=matmul, device=str(ctx.device))
    runner.create_video_model(None)
    w = gains(weights.make(weights.shapes_of(runner.model), ctx.seed, ctx.device))
    runner.model.load_state_dict(w)
    runner.set_data(None, VideoDataset(test["poses_3d"], test["poses_2d_gmm"], test["action_ids"],
                                       ACTIONS))
    return runner, cfg, w


def setup(ctx):
    try:
        from diffpose_tpu_torch.models.mixste import MixSTE  # noqa: F401
    except ImportError as e:
        raise SystemExit(f"error: cell {ctx.name}: the program has no MixSTE denoiser ({e})")
    frames = int(ctx.config["config"]["video"]["frames"])
    test = windows.windows(int(ctx.config["test_frames"]) // frames, frames, ctx.seed,
                           ctx.config["gmm_kernels"], device=ctx.device)
    runner, cfg, w = video_runner(ctx, test)
    runner.evaluate(is_train=True)                       # warm-up
    (key, fn), = runner._eval_cache.items()
    batch = cfg.training.batch_size
    per_pass = -(-len(test["poses_3d"]) // batch)
    cap = evalloop.Capture(fn, per_pass, evalloop.picks(ctx.seed, per_pass, ctx.cell["check"]["batches"]))
    runner._eval_cache[key] = cap
    x = cfg.mixste
    mix = counts_video.Mix(frames, cfg.model.n_pts, x.embed_dim, x.depth,
                           int(x.embed_dim * x.mlp_ratio), cfg.model.coords_dim[0],
                           cfg.model.coords_dim[1])
    seq = protocol.uniform_seq(cfg.testing.test_timesteps, cfg.testing.test_num_diffusion_timesteps)
    s = SimpleNamespace(
        ctx=ctx, runner=runner, cfg=cfg, capture=cap, test=test, w=w, per_pass=per_pass,
        kept=None,
        shapes=dict(family="video", batch=batch, test_times=cfg.testing.test_times,
                    ddim_steps=len(seq), seq=seq, mix=mix))
    s.time_blocks = lambda kind: time_blocks(s, kind)
    return s


def window(s, seconds):
    out = evalloop.run_window(s.runner, s.capture, seconds)
    s.attempted = out["units"]
    return out


def profile(s, slice_):
    paths = s.runner.model.temporal_paths
    before = dict(paths)
    evalloop.profile_pass(s.runner, s.capture, slice_, s.ctx.cell["trace"]["start"])
    print(f"temporal attention calls by path: the profiled pass "
          f"{ {k: v - before.get(k, 0) for k, v in paths.items()} }, the run {dict(paths)}",
          file=sys.stderr, flush=True)


def time_blocks(s, kind: str) -> float:
    """ms a call of the denoiser's ``depth`` spatial (``[B·F, J, D]``) or
    temporal (``[B·J, F, D]``) blocks, each with its shared norm, at the
    cell's batch of window-hypotheses, after the window: CUDA events over
    :data:`TIMED_CALLS` calls on the card, the host clock elsewhere."""
    from diffpose_tpu_torch.train.trainer import matmul_grade

    model, dev, m = s.runner.model, s.ctx.device, s.shapes["mix"]
    b = s.shapes["batch"] * s.shapes["test_times"]
    rows, seq = (b * m.frames, m.joints) if kind == "spatial" else (b * m.joints, m.frames)
    step = model.spatial if kind == "spatial" else model.temporal
    gen = torch.Generator(device=dev).manual_seed(s.ctx.seed)
    h = torch.randn((rows, seq, m.dim), generator=gen, device=dev)

    def call():
        x = h
        for i in range(m.depth):
            x = step(i, x)
        return x

    model.eval()
    with torch.no_grad(), matmul_grade(s.runner.eval_matmul_precision, dev):
        call(), call()
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(TIMED_CALLS):
                call()
            end.record()
            end.synchronize()
            return start.elapsed_time(end) / TIMED_CALLS
        t0 = time.perf_counter()
        for _ in range(TIMED_CALLS):
            call()
        return 1e3 * (time.perf_counter() - t0) / TIMED_CALLS


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
    rc = dict(depth=cfg.mixste.depth, heads=cfg.mixste.num_heads, ln_eps=cfg.mixste.ln_eps,
              test_times=cfg.testing.test_times, seq=s.shapes["seq"],
              betas=protocol.linear_betas(d["beta_start"], d["beta_end"], d["num_diffusion_timesteps"]),
              loader_seed=ctx.runner_seed, windows=REFERENCE_WINDOWS)
    p = to64(s.w, ctx.device)
    batch, n = cfg.training.batch_size, len(s.test["poses_3d"])
    limits = ctx.cell["check"]["limits"]
    numbers, failed = evalloop.compare(
        s.kept, lambda i: ref_mixste.eval_batch(p, s.test, protocol.batch_rows(i, batch, n), rc,
                                                ctx.device), limits)
    return numbers, limits, s.attempted, failed
