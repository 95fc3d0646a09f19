#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's frame family on one GPU and check it: the eval
and training functions, every kernel, and the command line over the runner.

Run from the root of a checkout, on a host with one NVIDIA H100:

    python3 chip_smoke.py            # add --profile for the fused step's kernels by device time

Phases (each fails loudly; none catches its own failure):

1. build every CUDA source under ``diffpose_tpu_torch/csrc`` (one nvcc per
   source, all at once) into ``build/``;
2. hold each kernel against its plain PyTorch version, on the card, at
   full width (hid 96, 5 layers, 4 heads, 17 joints) with seeded weights:
   the lifter at B=1024 and a ragged B=1000, the denoiser at B=1024 and
   5120 with t in {0, 12}; bound 5e-5;
3. run the eval path (GCNPose lift + 2-step DDIM with GCNDiff, seq (0, 12),
   51 linear betas 1e-4..1e-3, b=1024) at test_times 1 and 5 through
   ``make_eval_fn``, count the kernel launches (1 lifter + 2 denoiser per
   call) and compare with the same pipeline over the plain versions and
   over the nn.Module forwards; bound 2e-4;
4. time each kernel, its plain version and the eval call with CUDA events
   (warmed up, median of several runs);
5. hold the train-stack forward and backward kernels against their plain
   versions at full width with seeded masks at the reference dropout rates,
   B=1024 and a ragged B=1000: the output and every stash within 5e-5 of
   ``layers_forward``; ``dA0``, ``dtp`` and every weight gradient against
   ``torch.autograd.grad`` of it, every d-stash against the plain backward
   (|Δ| < 1e-5, else |Δ|/max|ref| < 1e-3); once with all rates 0 against
   ``GCNDiff.train()``'s own autograd;
6. run the training path: the synthetic dataset (8192 frames) on the card,
   ``make_train_step(impl="fused")`` at B=1024, Adam lr 2e-5, clip 1.0, EMA
   0.999, 20 steps, 1 forward + 1 backward launch each, the loss must fall;
   the same steps with the same draws through the plain versions (loss
   within 1e-3 and gradient norm within 1e-4 relative, parameters within
   1e-5 but for the entries whose gradient is rounding noise, see
   TOL_STEP_PARAMS); 25 steps at lr 1e-3 on one fixed draw, whose loss must
   fall; one sweep of 4 steps against 4 single steps;
7. time the two kernels, the weight-gradient products, the optimizer and
   EMA, whole fused, plain and module steps;
8. hold the seeded-dropout kernel pair (masks drawn in the kernels with
   Philox from a step seed) against its plain version, B=1024 and 1000: the
   masks the forward dumps equal ``ops/philox.py:philox_masks`` bit for bit,
   keep rates within 0.01 of 0.9 / 0.75 / 0.9, one seed gives one mask set and
   two seeds two; forward output and stashes within 5e-5 of ``layers_forward``
   over those masks; the backward, given no masks, within the limits of
   phase 5 of ``stack_bwd_plain`` over them;
9. time the seeded pair beside the explicit-mask pair, turn by turn, and
   the fused step with ``dropout="prng"`` beside ``"masks"``;
10. run the command line in process, ``diffpose_tpu_torch.cli.main_frame``
    with ``configs/human36m_diffpose_uvxyz_cpn.yml``, 8192 synthetic frames,
    B=1024, ``--train_impl fused --dropout_impl prng --denoiser_impl fused``:
    train 2 epochs (1 seeded forward + 1 seeded backward launch a step, 1
    lifter + 2 denoiser launches an eval batch, none of the explicit-mask
    pair), resume for a third, then evaluate the checkpoint's ``.pth`` files
    alone: files written, finite falling epoch losses, the eval-only P1/P2
    equal to the last epoch's to 1e-3 mm;
11. time the runner: train epochs (loader, copies, steps),
    ``throughput_stats()`` of an evaluation, and its layers one by one
    (loader gather, pinned copies, one eval step, the Procrustes metric).

The implicit (IGCN) family, at the width of ``configs/human36m_ipose.yml``
(hid 96, 5 layers, Anderson m=5, β=1, λ=0.1, 20/10 iterations, tolerance
0.1, B=512, t=12) with a seeded init:

12. hold the bare-stack kernel (kernel row 3, ``fused_backbone``) against
    ``backbone_plain`` at B=512, 1024 and a ragged 1000; bound 5e-5;
13. hold ``make_igcn_fn`` against its plain twin (``backbone_plain`` in
    place of the kernel) at a fixed iteration count where the solve does not
    amplify rounding (Anderson 5/5, its history not yet full; damped 20/20):
    output and fixed point within 2e-4; then at the config's solver, print
    both iteration counts, the difference, and the float32 plain solve's own
    distance from a float64 solve of the module (full-history Anderson
    amplifies rounding: see ``PERF.md``);
14. hold the fused implicit train step (the seeded kernel pair once per
    iteration) against the module step on the same draws, 3 steps each:
    damped 20/10 and Anderson 2/2 (loss within 1e-3 relative every step,
    BatchNorm buffers within 1e-5 after the first, every first-step
    gradient |Δ| < 1e-5 or 1e-3 relative); Anderson 3/3 with m=3, its
    history full (first-step gradients finite, float64 norms within a factor
    5); Anderson 20/10, the config (finite gradients); 1 + iterations launches of
    the seeded forward a step and as many of the backward as iterations
    (Anderson's last f(z) reaches nothing the loss reads);
15. run ``diffpose_tpu_torch.cli.main_implicit --use_implicit`` in process,
    ``configs/human36m_ipose.yml``, 4096 synthetic frames, B=512,
    ``--train_impl fused --dropout_impl prng --denoiser_impl fused``: train 2
    epochs, resume for a third, evaluate the checkpoint: launch counts (1
    lifter and 1 + iterations row-3 launches an eval batch, 21 seeded
    forward and 20 seeded backward launches a step, none of the explicit
    pair or the denoiser), files,
    finite losses, moved BatchNorm buffers, eval-only P1/P2 equal to the
    last epoch's;
16. time row 3, the eval solve, the train step by parts and the implicit
    runner (train epochs, ``throughput_stats()``).

The line before the last holds the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import functools
import json
import logging
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch

from diffpose_tpu_torch.data.loader import prefetch_to_device
from diffpose_tpu_torch.data.synthetic import make_synthetic_dataset
from diffpose_tpu_torch.diffusion import get_beta_schedule
from diffpose_tpu_torch.graph import H36M_EDGES, cheb_basis_from_edges
from diffpose_tpu_torch.metrics import p_mpjpe_per_sample
from diffpose_tpu_torch.models import IGCN, GCNDiff, GCNPose
from diffpose_tpu_torch.models.igcn import bn_eval, bn_state
from diffpose_tpu_torch.ops.fused_igcn import make_igcn_fn
from diffpose_tpu_torch.ops.fused_igcn_train import make_igcn_train_fn
from diffpose_tpu_torch.ops import _build
from diffpose_tpu_torch.ops.fused_denoiser import (
    _launch,
    _launch_backbone,
    backbone_plain,
    denoiser_plain,
    fused_backbone,
    fused_denoiser,
    fused_lifter,
    lifter_plain,
    net_plain,
    prepare_weights,
    timestep_projections,
)
from diffpose_tpu_torch.ops import fused_train as ft
from diffpose_tpu_torch.ops.fused_denoiser import _cheb
from diffpose_tpu_torch.ops.fused_pipeline import lift_and_denoise, make_eval_fn
from diffpose_tpu_torch.ops.philox import philox_masks
from diffpose_tpu_torch.ops.train_ref import layers_forward, make_dropout_masks
from diffpose_tpu_torch.models.ema import ema_register, ema_update
from diffpose_tpu_torch.train.optim import make_optimizer
from diffpose_tpu_torch.train.state import TrainState
from diffpose_tpu_torch.train.implicit_steps import make_implicit_train_step
from diffpose_tpu_torch.train.steps import make_train_step, make_train_sweep_step

SEED = 0
BATCH = 1024
SEQ = (0, 12)
BETAS = get_beta_schedule("linear", beta_start=1e-4, beta_end=1e-3, num_diffusion_timesteps=51)
TEST_TIMES = (1, 5)
TOL_KERNEL = 5e-5     # tests/test_pallas_denoiser.py holds the TPU kernel to this
TOL_PIPELINE = 2e-4   # tests/test_pallas_pipeline.py
# Gradients, as tests/test_pallas_train.py holds the TPU kernels: differences
# under GRAD_ABS pass (gradients that are mathematically 0), others must be
# under GRAD_REL of the reference's largest entry.
GRAD_ABS, GRAD_REL = 1e-5, 1e-3
PRNG_RATE_TOL = 0.01   # drawn keep rates against 0.9 / 0.75 / 0.9 (scripts/probe_prng_dropout.py)
TRAIN_STEPS = 20
TRAIN_FRAMES = 8192
FAST_STEPS = 25
TRAIN_LR = 2e-5
CLI_CONFIG = "configs/human36m_diffpose_uvxyz_cpn.yml"
CLI_FRAMES = 8192
TOL_STEP_LOSS = 1e-3       # relative, fused against plain, step by step
TOL_STEP_GRAD_NORM = 1e-4  # relative, step by step
# Parameters after TRAIN_STEPS Adam steps.  Adam divides by the root of the
# second moment, so where an entry's gradient is at the level of rounding
# noise (dead units, the key bias) the two versions' updates differ by up to
# 2·lr a step whatever the kernels' accuracy.  Hence: all but a share
# TOL_STEP_SHARE of the entries within TOL_STEP_PARAMS, and every entry
# within an eighth of that trivial bound.
TOL_STEP_PARAMS = 1e-5
TOL_STEP_SHARE = 1e-3
TOL_STEP_PARAMS_MAX = 2 * TRAIN_LR * TRAIN_STEPS / 8
# The implicit family (configs/human36m_ipose.yml)
IMPLICIT_CONFIG = "configs/human36m_ipose.yml"
IMPLICIT_BATCH = 512
ROW3_BATCHES = (IMPLICIT_BATCH, 1024, 1000)   # the main path's, the eval's, a ragged tile
IMPLICIT_T = 12               # testing.test_num_diffusion_timesteps
IMPLICIT_FRAMES = 4096        # 8 steps an epoch, 2 eval batches
IMPLICIT_STEPS = 3
# Fixed iteration counts at which the eval solve does not amplify rounding:
# Anderson before its history of 5 fills, the damped solver at full depth.
STABLE_SOLVES = (("anderson", 5), ("damped", 20))
# The train step, fused against module, as (solver, max, min iterations,
# Anderson history m, what is held): the damped solver at the config's depth
# and Anderson at 2 iterations (tests/test_pallas_igcn_train.py:54) are well
# conditioned, their gradients held entry by entry ("entries"); from 3
# iterations on the Gram solves amplify rounding, so at full history (m=3,
# 3 iterations, as tests/test_pallas_igcn_train.py:122) the gradient norms are
# held within a factor ("norms"), and at the config's 20 iterations, where the
# forward itself drifts and the norms reach 1e25, only finite ("finite").
TRAIN_SOLVES = (("damped", 20, 10, 5, "entries"), ("anderson", 2, 2, 5, "entries"),
                ("anderson", 3, 3, 3, "norms"), ("anderson", 20, 10, 5, "finite"))
GRAD_NORM_RATIO = 5.0
TOL_BN = 1e-5
# H100 SXM peaks (NVIDIA data sheet): FP32 on CUDA cores, HBM3.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def check(ok: bool, msg: str):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.detach() - b.detach()).abs().max())


def time_ms(fn, reps: int = 10, runs: int = 7) -> float:
    """Median over ``runs`` of the mean time of ``reps`` back-to-back calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


def randomize(model: torch.nn.Module, gen: torch.Generator):
    """Seeded perturbation of the parameters an init leaves trivial (identity
    adjacency, unit LayerNorm, zero ChebConv biases), so every term is live."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("A_hat"):
                p.add_(0.1 * torch.rand(p.shape, generator=gen))
            elif name.endswith(("bias", "a_2", "b_2")):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))


def net_flops(w, batch: int) -> int:
    """Multiply-adds (×2) of one forward as the kernel computes it."""
    H, L, n, nnz = w["hid_dim"], w["num_layers"], w["n_pts"], w["cheb_nnz"]
    gemm = H * 3 * H + H * H + H * 2 * H + 2 * H * H + 2 * (H * 3 * H)
    attention = 2 * n * H        # scores and value sums over n keys, all heads
    lap_mix = 2 * n * H          # two learned-adjacency mixes, H wide
    layer = n * (gemm + attention + lap_mix) + 2 * nnz * H
    io = n * (w["c_in"] * 3 * H + H * 3 * w["c_out"]) + nnz * (H + w["c_out"])
    return 2 * batch * (L * layer + io)


def net_bytes(w, batch: int) -> int:
    """Inputs read once and the output written once."""
    weights = sum(v.numel() * v.element_size() for k, v in w.items()
                  if isinstance(v, torch.Tensor) and k not in ("basis", "t0k", "t0b", "t1k",
                                                               "t1b", "wtp", "btp"))
    act = batch * w["n_pts"] * (w["c_in"] + w["c_out"])
    if w["has_temb"]:
        act += w["num_layers"] * batch * w["hid_dim"]
    return weights + 4 * act


def bound_ms(w, batch: int):
    ops_ms = 1e3 * net_flops(w, batch) / PEAK_FP32
    bytes_ms = 1e3 * net_bytes(w, batch) / PEAK_BYTES
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def grad_close(got: torch.Tensor, want: torch.Tensor) -> float:
    """0 where the difference is under GRAD_ABS, else it relative to the
    reference's largest entry."""
    d = float((got - want).abs().max())
    return 0.0 if d < GRAD_ABS else d / (float(want.abs().max()) + 1e-8)


def train_flops(w, batch: int):
    """Multiply-adds (×2) of the stack forward and backward as the kernels compute them."""
    H, L, n, nnz = w["hid_dim"], w["num_layers"], w["n_pts"], w["cheb_nnz"]
    fwd_gemm = H * 3 * H + H * H + H * 2 * H + 2 * H * H + 2 * (H * 3 * H)
    fwd = n * (fwd_gemm + 2 * n * H + 2 * n * H) + 2 * nnz * H
    # two transposed Chebyshev products, fc2ᵀ, fc1ᵀ, out-projᵀ, the QKV recompute, QKVᵀ
    bwd_gemm = 2 * (3 * H * H) + 2 * (2 * H * H) + H * H + 2 * (H * 3 * H)
    # scores, dp, dq, dk, dv over n keys; two transposed learned-adjacency mixes
    bwd = n * (bwd_gemm + 5 * n * H + 2 * n * H) + 2 * nnz * H
    return 2 * batch * L * fwd, 2 * batch * L * bwd


def train_bytes(w, batch: int):
    """Inputs read once and outputs written once, forward and backward."""
    H, L, n, heads = w["hid_dim"], w["num_layers"], w["n_pts"], w["num_heads"]
    weights = 4 * sum(w[k].numel() for k in ft.STACK_KEYS)
    masks = L * batch * (heads * n * n + 4 * n * H)
    row = 4 * batch * n * H                      # one [B, 17, H] f32 array
    fwd = weights + masks + row + 4 * L * batch * H + row + L * row * 10     # h0, tp, d5, stashes
    bwd = weights + masks + row + L * row * 7 + row + 4 * L * batch * H + L * row * 9
    return fwd, bwd


def bound_of(flops: int, nbytes: int):
    ops_ms, bytes_ms = 1e3 * flops / PEAK_FP32, 1e3 * nbytes / PEAK_BYTES
    return (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")


def profile_fused_step(state_and_step, draws, steps: int = 5):
    """``--profile``: the device kernels of ``steps`` fused train steps by
    total device time, and the device's busy share of the window."""
    from torch.profiler import ProfilerActivity, profile

    state, step = state_and_step
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            step.apply(state, draws)
        torch.cuda.synchronize()
    wall_ms = 1e3 * (time.perf_counter() - t0)
    events = [e for e in prof.key_averages() if e.device_time_total > 0 and e.device_type.name == "CUDA"]
    busy_ms = sum(e.device_time_total for e in events) / 1e3
    print(f"profile of {steps} fused steps: wall {wall_ms:.2f} ms (tracing on), device busy "
          f"{busy_ms:.2f} ms ({100 * busy_ms / wall_ms:.0f}%)")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:25]:
        print(f"  {e.device_time_total / 1e3 / steps:8.4f} ms/step  x{e.count / steps:6.1f}  {e.key[:110]}")
    host = [e for e in prof.key_averages() if e.self_cpu_time_total > 0]
    print(f"host side, by self time ({sum(e.self_cpu_time_total for e in host) / 1e3 / steps:.2f} "
          f"ms/step inside operators, {sum(e.count for e in host) / steps:.0f} operator calls/step):")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:25]:
        print(f"  {e.self_cpu_time_total / 1e3 / steps:8.4f} ms/step  x{e.count / steps:6.1f}  {e.key[:110]}")


def train_phases(dev, basis, diff, g):
    """Phases 5-7; returns the two train kernels' records."""
    L, H, heads, n = diff.num_layers, diff.hid_dim, diff.num_heads, 17
    wt = prepare_weights(diff)
    ikeep = ft._inv_keep(None)
    errs = {"fwd": 0.0, "bwd": 0.0}
    kept = {}

    # 5. kernels against their plain versions
    for bsz in (BATCH, 1000):
        x = torch.randn((bsz, n, 5), generator=g, device=dev)
        t = torch.randint(0, len(BETAS), (bsz,), generator=g, device=dev).to(torch.float32)
        masks = make_dropout_masks(g, num_layers=L, n_pts=n, batch=bsz, num_heads=heads, hid_dim=H)
        km = ft.kernel_masks(masks)
        with torch.no_grad():
            tp = timestep_projections(wt, t)
            h0 = _cheb(x, wt["win"], wt["bin"], wt["basis"]).contiguous()
        d5, st = ft._launch_fwd(wt, h0, tp, km, ikeep)
        torch.cuda.synchronize()
        wr = dict(wt, **{k: wt[k].clone().requires_grad_() for k in ft.STACK_KEYS})
        h0r, tpr = h0.clone().requires_grad_(), tp.clone().requires_grad_()
        d5_plain, st_plain = layers_forward(wr, h0r, tpr, masks, return_stashes=True)
        e_fwd = {"d5": max_err(d5, d5_plain), **{k: max_err(st[k], st_plain[k]) for k in st}}
        print(f"train fwd B={bsz:5d}: max|kernel-plain| " +
              "  ".join(f"{k} {v:.2e}" for k, v in e_fwd.items()))
        check(max(e_fwd.values()) <= TOL_KERNEL, f"train forward kernel B={bsz}")
        errs["fwd"] = max(errs["fwd"], *e_fwd.values())

        # The backward gets the plain forward's stashes, so that kernel and
        # reference gate their ReLUs alike: an activation that is 0 in one
        # forward and 1e-7 in the other would pass a whole gradient entry.
        st_ref = {k: v.detach().contiguous() for k, v in st_plain.items()}
        dd5 = torch.randn((bsz, n, H), generator=g, device=dev)
        da0, dtp, ds = ft._launch_bwd(wt, km, st_ref, dd5, ikeep)
        torch.cuda.synchronize()
        wgrads = ft.weight_grads(wt, st_ref, ds)
        ref = torch.autograd.grad(d5_plain, [h0r, tpr, *[wr[k] for k in ft.STACK_KEYS]], dd5,
                                  retain_graph=bsz == BATCH)  # phase 7 times it again
        with torch.no_grad():
            _, _, ds_plain = ft.stack_bwd_plain(wt, masks, st_ref, dd5)
        rel = {"dA0": grad_close(da0, ref[0]), "dtp": grad_close(dtp, ref[1]),
               **{k: grad_close(ds[k], ds_plain[k]) for k in ds},
               **{k: grad_close(wgrads[k], r) for k, r in zip(ft.STACK_KEYS, ref[2:])}}
        print(f"train bwd B={bsz:5d}: rel err (0 = under {GRAD_ABS:g} abs) " +
              "  ".join(f"{k} {v:.1e}" for k, v in rel.items()))
        check(max(rel.values()) < GRAD_REL, f"train backward kernel B={bsz}: {rel}")
        errs["bwd"] = max(errs["bwd"], max_err(da0, ref[0]), max_err(dtp, ref[1]),
                          *[max_err(ds[k], ds_plain[k]) for k in ds])
        if bsz == BATCH:
            kept = dict(h0=h0, tp=tp, km=km, masks=masks, st=st, ds=ds, dd5=dd5, wr=wr, h0r=h0r,
                        tpr=tpr, d5_plain=d5_plain)
        del ref, d5_plain, st_plain, st_ref

    # all rates 0: the fused forward and backward against GCNDiff.train() under autograd
    quiet = copy.deepcopy(diff).train()
    for mod in quiet.modules():
        if isinstance(mod, torch.nn.Dropout):
            mod.p = 0.0
    x = torch.randn((BATCH, n, 5), generator=g, device=dev)
    t = torch.randint(0, len(BETAS), (BATCH,), generator=g, device=dev).to(torch.float32)
    e = torch.randn((BATCH, n, 5), generator=g, device=dev)
    ones = make_dropout_masks(g, num_layers=L, n_pts=n, batch=BATCH, num_heads=heads, hid_dim=H,
                              dtype=torch.uint8, rates=(0.0, 0.0, 0.0))
    stack0 = ft.build_train_stack(basis, num_layers=L, num_heads=heads, hid_dim=H,
                                  rates=(0.0, 0.0, 0.0))
    params = list(quiet.parameters())
    out_f = ft.fused_train_forward(quiet, x, t, ones, stack0)
    g_f = torch.autograd.grad(((e - out_f) ** 2).sum(dim=(1, 2)).mean(), params)
    out_m = quiet(x, t)
    g_m = torch.autograd.grad(((e - out_m) ** 2).sum(dim=(1, 2)).mean(), params)
    e_out = max_err(out_f, out_m)
    worst = max((grad_close(a, b), name) for (name, _), a, b in
                zip(quiet.named_parameters(), g_f, g_m))
    print(f"rates 0 vs GCNDiff.train(): max|out| {e_out:.3e}  worst grad rel {worst[0]:.1e} ({worst[1]})")
    check(e_out <= TOL_KERNEL and worst[0] < GRAD_REL, "fused train forward/backward at rates 0")
    del out_f, out_m, g_f, g_m

    # 6. the training path
    data = make_synthetic_dataset(num_frames=TRAIN_FRAMES, seed=SEED)
    data = {"poses_3d": torch.as_tensor(data.poses_3d, device=dev),
            "poses_2d_gmm": torch.as_tensor(data.poses_2d_gmm, device=dev)}
    idx = torch.randperm(TRAIN_FRAMES, generator=g, device=dev)

    def batch_of(i):
        ids = idx[(i * BATCH) % TRAIN_FRAMES:][:BATCH]
        return {k: v.index_select(0, ids) for k, v in data.items()}

    def fresh(impl, lr=TRAIN_LR, dropout="masks"):
        model = copy.deepcopy(diff).train()
        opt = make_optimizer(model.parameters(), lr=lr)
        state = TrainState.create(model, opt, ema_register(model))
        return state, make_train_step(model, opt, BETAS, impl=impl, ema_mu=0.999, dropout=dropout)

    state, step = fresh("fused")
    draws = [step.draw(batch_of(i), g) for i in range(TRAIN_STEPS)]
    torch.cuda.synchronize()
    ft.stack_fwd.launches = ft.stack_bwd.launches = 0
    losses, norms = [], []
    for i, d in enumerate(draws, start=1):
        state, metrics = step.apply(state, d)
        losses.append(metrics["loss"])
        norms.append(metrics["grad_norm"])
        check((ft.stack_fwd.launches, ft.stack_bwd.launches) == (i, i),
              f"launch counts after train step {i}: forward {ft.stack_fwd.launches}, "
              f"backward {ft.stack_bwd.launches}")
        if i == 1:
            moved = max(max_err(state.ema_params[k], p) for k, p in state.model.named_parameters())
            check(moved > 0, "EMA shadow equals the parameters after step 1")
    torch.cuda.synchronize()
    launches = {"fwd": ft.stack_fwd.launches, "bwd": ft.stack_bwd.launches}
    losses, norms = [float(v) for v in losses], [float(v) for v in norms]
    print(f"main path (train) launches over {TRAIN_STEPS} steps: {launches}")
    print("fused step losses: " + " ".join(f"{v:.4f}" for v in losses))
    check(all(v == v and abs(v) != float("inf") for v in losses), "a training loss is not finite")
    check(all(bool(torch.isfinite(p).all()) for p in state.model.parameters()),
          "a parameter is not finite after training")

    pstate, pstep = fresh("plain")
    pmetrics = [pstep.apply(pstate, d)[1] for d in draws]
    rel_loss = max(abs(a - float(m["loss"])) / abs(float(m["loss"])) for a, m in zip(losses, pmetrics))
    rel_norm = max(abs(a - float(m["grad_norm"])) / float(m["grad_norm"])
                   for a, m in zip(norms, pmetrics))
    diffs = torch.cat([(a.detach() - b.detach()).abs().flatten() for a, b in
                       zip(state.model.parameters(), pstate.model.parameters())])
    dpar = max((max_err(a, b), name) for (name, a), b in
               zip(state.model.named_parameters(), pstate.model.parameters()))
    share = float((diffs > TOL_STEP_PARAMS).float().mean())
    dema = max(max_err(state.ema_params[k], pstate.ema_params[k]) for k in state.ema_params)
    print(f"fused vs plain over {TRAIN_STEPS} steps: max rel loss diff {rel_loss:.3e}  "
          f"max rel grad-norm diff {rel_norm:.3e}  max|param diff| {dpar[0]:.3e} ({dpar[1]})  "
          f"share of entries over {TOL_STEP_PARAMS:g}: {share:.3e}  max|ema diff| {dema:.3e}")
    check(rel_loss <= TOL_STEP_LOSS and rel_norm <= TOL_STEP_GRAD_NORM,
          "fused steps against plain steps: loss or gradient norm")
    check(share <= TOL_STEP_SHARE and dpar[0] <= TOL_STEP_PARAMS_MAX,
          "fused steps against plain steps: parameters")
    del pstate, pstep

    check(sum(losses[-5:]) < sum(losses[:5]), f"the loss did not fall over {TRAIN_STEPS} steps")
    # A rate fifty times the config's, on one fixed draw: Adam overshoots in
    # its first steps (every entry moves by the full rate), then descends.
    fstate, fstep = fresh("fused", lr=1e-3)
    falling = [float(fstep.apply(fstate, draws[0])[1]["loss"]) for _ in range(FAST_STEPS)]
    print(f"lr 1e-3, {FAST_STEPS} steps on one fixed draw, losses: " +
          " ".join(f"{v:.4f}" for v in falling))
    check(max(falling[-5:]) < falling[0], "the loss did not fall at lr 1e-3")
    del fstate, fstep

    a_state, a_step = fresh("fused")
    b_state, b_step = fresh("fused")
    sweep = make_train_sweep_step(a_state.model, a_state.optimizer, BETAS, sweep=4, base_step=a_step)
    sidx = idx[:4 * BATCH].reshape(4, BATCH)
    ga, gb = (torch.Generator(device=dev).manual_seed(SEED + 1) for _ in range(2))
    a_state, sw = sweep(a_state, data, sidx, ga)
    singles = []
    for ids in sidx:
        b_state, m = b_step(b_state, {k: v.index_select(0, ids) for k, v in data.items()}, gb)
        singles.append(m["loss"])
    dsw = max(max_err(a, b) for a, b in zip(a_state.model.parameters(), b_state.model.parameters()))
    dls = max_err(sw["loss"], torch.stack(singles))
    print(f"sweep of 4 vs 4 single steps: max|param diff| {dsw:.3e}  max|loss diff| {dls:.3e}")
    check(dsw <= 1e-6 and dls <= 1e-4 and a_state.step == b_state.step == 4,
          "sweep step against single steps")
    del a_state, b_state

    # 7. times
    k = kept
    fwd_ms = time_ms(lambda: ft._launch_fwd(wt, k["h0"], k["tp"], k["km"], ikeep))
    bwd_ms = time_ms(lambda: ft._launch_bwd(wt, k["km"], k["st"], k["dd5"], ikeep))
    wg_ms = time_ms(lambda: ft.weight_grads(wt, k["st"], k["ds"]))
    with torch.no_grad():
        plain_fwd_ms = time_ms(lambda: layers_forward(wt, k["h0"], k["tp"], k["masks"]), reps=3)
    grad_inputs = [k["h0r"], k["tpr"], *[k["wr"][key] for key in ft.STACK_KEYS]]
    plain_bwd_ms = time_ms(lambda: torch.autograd.grad(k["d5_plain"], grad_inputs, k["dd5"],
                                                       retain_graph=True), reps=3)
    (f_fl, b_fl), (f_by, b_by) = train_flops(wt, BATCH), train_bytes(wt, BATCH)
    (f_bound, f_by_what), (b_bound, b_by_what) = bound_of(f_fl, f_by), bound_of(b_fl, b_by)
    print(f"train fwd kernel B={BATCH}: {fwd_ms:.4f} ms  plain {plain_fwd_ms:.4f} ms  bound "
          f"{f_bound:.4f} ms ({f_by_what}; {f_fl / 1e9:.2f} GFLOP, {f_by / 1e6:.1f} MB)  "
          f"{f_fl / fwd_ms / 1e9:.1f} TFLOP/s")
    print(f"train bwd kernel B={BATCH}: {bwd_ms:.4f} ms  plain autograd {plain_bwd_ms:.4f} ms  bound "
          f"{b_bound:.4f} ms ({b_by_what}; {b_fl / 1e9:.2f} GFLOP, {b_by / 1e6:.1f} MB)  "
          f"{b_fl / bwd_ms / 1e9:.1f} TFLOP/s")
    print(f"weight_grads B={BATCH}: {wg_ms:.4f} ms")

    step_ms = {}
    for impl in ("fused", "plain", "module"):
        s_state, s_step = fresh(impl)
        d = s_step.draw(batch_of(0), g)
        step_ms[impl] = time_ms(lambda: s_step.apply(s_state, d), reps=5)
        if impl == "fused":
            s_fused, d_fused = (s_state, s_step), d
            draw_ms = time_ms(lambda: s_step.draw(batch_of(0), g), reps=5)
            whole_ms = time_ms(lambda: s_step(s_state, batch_of(0), g), reps=5)

            def opt_ema():
                s_state.optimizer.step()
                ema_update(s_state.ema_params, s_state.model, 0.999)
            opt_ms = time_ms(opt_ema, reps=5)
    rest = step_ms["fused"] - fwd_ms - bwd_ms - wg_ms - opt_ms
    print(f"train step B={BATCH} (draws given): fused {step_ms['fused']:.4f} ms  "
          f"plain {step_ms['plain']:.4f} ms  module {step_ms['module']:.4f} ms")
    print(f"fused step parts: forward kernel {fwd_ms:.4f}  backward kernel {bwd_ms:.4f}  "
          f"weight_grads {wg_ms:.4f}  clip+Adam+EMA {opt_ms:.4f}  rest {rest:.4f} ms")
    print(f"fused step with its draws: draw {draw_ms:.4f} ms  whole {whole_ms:.4f} ms  "
          f"{BATCH / whole_ms * 1e3:.1f} frames/s")

    if "--profile" in sys.argv[1:]:
        profile_fused_step(s_fused, d_fused)

    common = dict(route="cuda", source="diffpose_tpu_torch/csrc/train_kernel.cu", library_ms=None,
                  batch=BATCH, steps=TRAIN_STEPS)
    ctx = dict(wt=wt, kept=kept, fresh=fresh, batch_of=batch_of, bounds=(f_bound, b_bound))
    return ctx, [
        dict(name="train_kernel[fwd]", replaces="diffpose_tpu/ops/pallas_train.py:215",
             launches=launches["fwd"], max_abs_err=errs["fwd"], ms=fwd_ms, plain_ms=plain_fwd_ms,
             bound_ms=f_bound, bound_by=f_by_what, **common),
        dict(name="train_kernel[bwd]", replaces="diffpose_tpu/ops/pallas_train.py:531",
             launches=launches["bwd"], max_abs_err=errs["bwd"], ms=bwd_ms, plain_ms=plain_bwd_ms,
             bound_ms=b_bound, bound_by=b_by_what, **common),
    ]


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    return smi.stdout.strip().splitlines()[0]


def prng_phases(dev, diff, g, ctx, card):
    """Phases 8-9: the seeded-dropout kernel pair against its plain version,
    and its times; returns the two kernels' records without their launches."""
    L, H, heads, n = diff.num_layers, diff.hid_dim, diff.num_heads, 17
    wt, ikeep = ctx["wt"], ft._inv_keep(None)
    shape = dict(num_layers=L, n_pts=n, num_heads=heads, hid_dim=H)
    errs = {"fwd": 0.0, "bwd": 0.0}
    kept = {}

    # 8. kernels against their plain versions
    for bsz in (BATCH, 1000):
        x = torch.randn((bsz, n, 5), generator=g, device=dev)
        t = torch.randint(0, len(BETAS), (bsz,), generator=g, device=dev).to(torch.float32)
        seed = torch.randint(-(1 << 31), (1 << 31) - 1, (1,), generator=g, device=dev,
                             dtype=torch.int32)
        with torch.no_grad():
            tp = timestep_projections(wt, t)
            h0 = _cheb(x, wt["win"], wt["bin"], wt["basis"]).contiguous()
        d5, st, dumped = ft.stack_fwd_prng(wt, h0, tp, seed, dump=True)
        torch.cuda.synchronize()
        masks = philox_masks(seed, batch=bsz, device=dev, **shape)
        same = {k: bool(torch.equal(dumped[k], getattr(masks, k))) for k in ft.MASK_KEYS}
        rates = {k: float(dumped[k].float().mean()) for k in ft.MASK_KEYS}
        print(f"prng masks B={bsz:5d} seed {int(seed):11d}: dumped == philox_masks {same}  keep rates " +
              "  ".join(f"{k} {v:.4f}" for k, v in rates.items()))
        check(all(same.values()), f"dumped masks differ from philox_masks at B={bsz}: {same}")
        for k, want in zip(ft.MASK_KEYS, (0.9, 0.75, 0.75, 0.9, 0.9)):
            check(abs(rates[k] - want) < PRNG_RATE_TOL, f"keep rate of {k}: {rates[k]} against {want}")
        again = ft.stack_fwd_prng(wt, h0, tp, seed, dump=True)[2]
        other = ft.stack_fwd_prng(wt, h0, tp, seed + 1, dump=True)[2]
        check(all(torch.equal(again[k], dumped[k]) for k in ft.MASK_KEYS), "one seed, two mask sets")
        differ = {k: float((other[k] != dumped[k]).float().mean()) for k in ft.MASK_KEYS}
        check(all(v > 0.05 for v in differ.values()), f"two seeds give the same masks: {differ}")
        d5_nodump, _ = ft.stack_fwd_prng(wt, h0, tp, seed)
        check(bool(torch.equal(d5_nodump, d5)), "the dump changes the forward's output")

        d5_plain, st_plain = layers_forward(wt, h0, tp, masks, return_stashes=True)
        e_fwd = {"d5": max_err(d5, d5_plain), **{k: max_err(st[k], st_plain[k]) for k in st}}
        print(f"prng fwd B={bsz:5d}: max|kernel-plain| " +
              "  ".join(f"{k} {v:.2e}" for k, v in e_fwd.items()))
        check(max(e_fwd.values()) <= TOL_KERNEL, f"seeded train forward kernel B={bsz}")
        errs["fwd"] = max(errs["fwd"], *e_fwd.values())

        # The backward gets the plain forward's stashes (see phase 5) and no
        # masks: agreeing with the plain backward over philox_masks shows that
        # it regenerates the forward's bits.
        st_ref = {k: v.contiguous() for k, v in st_plain.items()}
        dd5 = torch.randn((bsz, n, H), generator=g, device=dev)
        da0, dtp, ds = ft.stack_bwd_prng(wt, seed, st_ref, dd5)
        torch.cuda.synchronize()
        da0_p, dtp_p, ds_p = ft.stack_bwd_plain(wt, masks, st_ref, dd5)
        wg, wg_p = ft.weight_grads(wt, st_ref, ds), ft.weight_grads(wt, st_ref, ds_p)
        rel = {"dA0": grad_close(da0, da0_p), "dtp": grad_close(dtp, dtp_p),
               **{k: grad_close(ds[k], ds_p[k]) for k in ds},
               **{k: grad_close(wg[k], wg_p[k]) for k in ft.STACK_KEYS}}
        print(f"prng bwd B={bsz:5d}: rel err (0 = under {GRAD_ABS:g} abs) " +
              "  ".join(f"{k} {v:.1e}" for k, v in rel.items()))
        check(max(rel.values()) < GRAD_REL, f"seeded train backward kernel B={bsz}: {rel}")
        errs["bwd"] = max(errs["bwd"], max_err(da0, da0_p), max_err(dtp, dtp_p),
                          *[max_err(ds[k], ds_p[k]) for k in ds])
        if bsz == BATCH:
            kept = dict(h0=h0, tp=tp, seed=seed, st=st, dd5=dd5, masks=masks)
        del st_plain, st_ref, ds_p, wg, wg_p

    # 9. times: the seeded pair beside the explicit-mask pair, turn by turn
    k, ke = kept, ctx["kept"]
    drop = ft._seeded(k["seed"], None)
    runs = {
        "fwd": (lambda: ft._launch_fwd(wt, k["h0"], k["tp"], drop, ikeep),
                lambda: ft._launch_fwd(wt, ke["h0"], ke["tp"], ke["km"], ikeep)),
        "bwd": (lambda: ft._launch_bwd(wt, drop, k["st"], k["dd5"], ikeep),
                lambda: ft._launch_bwd(wt, ke["km"], ke["st"], ke["dd5"], ikeep)),
    }
    ms = {}
    for name, (seeded, explicit) in runs.items():
        a, b, c, d = time_ms(explicit), time_ms(seeded), time_ms(seeded), time_ms(explicit)
        ms[name] = ((b + c) / 2, (a + d) / 2)
        print(f"prng {name} kernel B={BATCH}: seeded {b:.4f} {c:.4f} ms  explicit masks {a:.4f} "
              f"{d:.4f} ms  bound {ctx['bounds'][name == 'bwd']:.4f} ms (operations)  [{card}]")
    # the plain versions: philox_masks (numpy on the host, timed once) and then
    # layers_forward / stack_bwd_plain with those masks
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    philox_masks(k["seed"], batch=BATCH, device=dev, **shape)
    torch.cuda.synchronize()
    philox_ms = 1e3 * (time.perf_counter() - t0)
    with torch.no_grad():
        plain_fwd = time_ms(lambda: layers_forward(wt, k["h0"], k["tp"], k["masks"]), reps=3)
        plain_bwd = time_ms(lambda: ft.stack_bwd_plain(wt, k["masks"], k["st"], k["dd5"]), reps=3)
    print(f"prng plain versions B={BATCH}: philox_masks {philox_ms:.1f} ms on the host, then "
          f"layers_forward {plain_fwd:.4f} ms, stack_bwd_plain {plain_bwd:.4f} ms")

    step_ms = {}
    for dropout in ("masks", "prng", "prng", "masks"):
        s_state, s_step = ctx["fresh"]("fused", dropout=dropout)
        d = s_step.draw(ctx["batch_of"](0), g)
        got = (time_ms(lambda: s_step.draw(ctx["batch_of"](0), g), reps=5),
               time_ms(lambda: s_step.apply(s_state, d), reps=5),
               time_ms(lambda: s_step(s_state, ctx["batch_of"](0), g), reps=5))
        step_ms.setdefault(dropout, []).append(got)
        print(f"fused step B={BATCH} dropout={dropout:5s}: draw {got[0]:.4f}  apply {got[1]:.4f}  "
              f"whole {got[2]:.4f} ms  {BATCH / got[2] * 1e3:.1f} frames/s  [{card}]")

    common = dict(route="cuda", source="diffpose_tpu_torch/csrc/train_kernel.cu", library_ms=None,
                  batch=BATCH, bound_by="operations")
    return [
        dict(name="train_kernel[fwd,prng]", replaces="diffpose_tpu/ops/pallas_train.py:314",
             max_abs_err=errs["fwd"], ms=ms["fwd"][0], explicit_masks_ms=ms["fwd"][1],
             plain_ms=philox_ms + plain_fwd, bound_ms=ctx["bounds"][0], **common),
        dict(name="train_kernel[bwd,prng]", replaces="diffpose_tpu/ops/pallas_train.py:581",
             max_abs_err=errs["bwd"], ms=ms["bwd"][0], explicit_masks_ms=ms["bwd"][1],
             plain_ms=philox_ms + plain_bwd, bound_ms=ctx["bounds"][1], **common),
    ]


def reset_launch_counts():
    for fn in (fused_lifter, fused_denoiser, fused_backbone, ft.stack_fwd, ft.stack_bwd,
               ft.stack_fwd_prng, ft.stack_bwd_prng):
        fn.launches = 0


def launch_counts() -> dict:
    return {"lifter": fused_lifter.launches, "denoiser": fused_denoiser.launches,
            "backbone": fused_backbone.launches,
            "fwd": ft.stack_fwd.launches, "bwd": ft.stack_bwd.launches,
            "fwd_prng": ft.stack_fwd_prng.launches, "bwd_prng": ft.stack_bwd_prng.launches}


def logged_errors(stdout_txt: Path):
    """Every ``MPJPE: x | P-MPJPE: y`` line the runner logged (mm, 4 decimals)."""
    return [(float(a), float(b)) for a, b in
            re.findall(r" - MPJPE: ([0-9.]+) \| P-MPJPE: ([0-9.]+)", stdout_txt.read_text())]


def cli_phases(card):
    """Phases 10-11: the port's command line, in process, at full width:
    train 2 epochs, resume for a third, evaluate the checkpoint; then the
    runner's own times.  Returns the launch counts of the training run."""
    from diffpose_tpu_torch.cli import main_frame
    from diffpose_tpu_torch.cli.common import setup_experiment
    from diffpose_tpu_torch.train.trainer import DiffposeRunner

    exp = Path(tempfile.mkdtemp(prefix="chip_smoke_exp_"))
    steps_per_epoch = -(-CLI_FRAMES // BATCH)
    eval_batches = -(-(CLI_FRAMES // 4) // BATCH)
    common = ["--config", CLI_CONFIG, "--exp", str(exp), "--ni", "--synthetic_frames",
              str(CLI_FRAMES), "--batch_size", str(BATCH), "--denoiser_impl", "fused"]
    train = common + ["--doc", "run", "--train", "--train_impl", "fused", "--dropout_impl", "prng"]
    run = exp / "run"

    # 10. train, resume, eval-only
    reset_launch_counts()
    check(main_frame.main(train + ["--n_epochs", "2"]) == 0, "the CLI training run failed")
    torch.cuda.synchronize()
    counts = launch_counts()
    want = {"lifter": 2 * eval_batches, "denoiser": 2 * len(SEQ) * eval_batches, "backbone": 0,
            "fwd": 0, "bwd": 0, "fwd_prng": 2 * steps_per_epoch, "bwd_prng": 2 * steps_per_epoch}
    print(f"main path (CLI: 2 epochs of {steps_per_epoch} steps, {eval_batches} eval batches each) "
          f"launches: {counts}")
    check(counts == want, f"CLI training run launches {counts}, expected {want}")
    check(main_frame.main(train + ["--n_epochs", "3", "--resume"]) == 0, "the CLI resume failed")
    log = (run / "stdout.txt").read_text()
    check(f"resumed from step {2 * steps_per_epoch} (epoch 2)" in log, "the resume was not logged")
    check(log.count("| Epoch 00") == 3, "the resumed run did not train exactly one more epoch")
    rows = [line.split("\t") for line in (run / "log.tsv").read_text().splitlines()[1:]]
    losses = [float(r[2]) for r in rows]
    print(f"CLI log.tsv: {len(rows)} rows, epoch losses {losses}, P1 {[float(r[3]) for r in rows]}")
    check(len(rows) == 3 and all(v == v and abs(v) != float("inf") for v in losses),
          f"log.tsv rows or losses: {rows}")
    check(losses[-1] < losses[0], f"the epoch loss did not fall: {losses}")
    last = 3 * steps_per_epoch
    files = sorted(f.name for f in run.iterdir())
    for name in ("config.yml", "stdout.txt", "log.tsv", f"ckpt_{last:08d}.pth",
                 f"ckpt_{last:08d}.pose.pth"):
        check(name in files, f"{name} missing from the run's folder: {files}")

    reset_launch_counts()
    check(main_frame.main(common + [
        "--doc", "evalonly", "--track_metrics",
        "--model_diff_path", str(run / f"ckpt_{last:08d}.pth"),
        "--model_pose_path", str(run / f"ckpt_{last:08d}.pose.pth")]) == 0, "the CLI eval run failed")
    e_counts = launch_counts()
    check(e_counts == dict(want, lifter=eval_batches, denoiser=len(SEQ) * eval_batches,
                           fwd_prng=0, bwd_prng=0), f"CLI eval-only launches {e_counts}")
    trained, alone = logged_errors(run / "stdout.txt")[-1], logged_errors(exp / "evalonly" / "stdout.txt")[-1]
    print(f"eval-only from the checkpoint: P1/P2 {alone} mm, the training run's last epoch {trained} mm")
    check(max(abs(a - b) for a, b in zip(trained, alone)) <= 1e-3,
          "eval-only from the checkpoint disagrees with the training run's last eval")
    check("throughput: {" in (exp / "evalonly" / "stdout.txt").read_text(), "no throughput line")

    # 11. the runner's times: epochs of the train loop alone (loader, copies,
    # steps, one read of the losses), and throughput_stats() of an evaluation
    args = main_frame.parse_args(train + ["--doc", "times", "--n_epochs", "4"])
    config = setup_experiment(args)
    runner = DiffposeRunner(config, seed=args.seed, log_dir=None, denoiser_impl="fused",
                            train_impl="fused", dropout_impl="prng")
    runner.create_diffusion_model()
    runner.create_pose_model()
    runner.set_data(make_synthetic_dataset(CLI_FRAMES, seed=args.seed),
                    make_synthetic_dataset(CLI_FRAMES // 4, seed=args.seed + 1))
    runner.train()
    secs = runner.train_seconds
    runner.evaluate(is_train=True)
    stats = runner.throughput_stats()
    print(f"runner train epochs of {CLI_FRAMES} frames at B={BATCH} (fused, prng): " +
          " ".join(f"{v:.4f}" for v in secs) +
          f" s; last epoch {CLI_FRAMES / secs[-1]:.1f} frames/s  [{card}]")
    print(f"runner eval (fused, tt={config.testing.test_times}): {stats}  [{card}]")

    # the runner's layers one by one: the loader's host gather, the same with
    # its pinned copies to the card, one eval step on a batch that lies on
    # the card, and the Procrustes metric alone
    dev = runner.device
    loader = runner._make_loader(runner.train_data, shuffle=True)
    t0 = time.perf_counter()
    n_batches = sum(1 for _ in loader.epoch(0))
    gather_ms = 1e3 * (time.perf_counter() - t0) / n_batches
    t0 = time.perf_counter()
    for batch in prefetch_to_device(loader.epoch(0), size=2, device=dev):
        pass
    torch.cuda.synchronize()
    copy_ms = 1e3 * (time.perf_counter() - t0) / n_batches
    eval_fn = runner._get_eval_fn(SEQ)
    prepared = eval_fn.prepare(runner.state, runner.pose_params)
    step_ms = time_ms(lambda: eval_fn(runner.state, runner.pose_params, batch, None,
                                      prepared=prepared), reps=5)
    pred, target = torch.randn(2, BATCH, 17, 3, device=dev).unbind(0)
    p2_ms = time_ms(lambda: p_mpjpe_per_sample(pred, target), reps=5)
    print(f"runner layers at B={BATCH}: loader gather {gather_ms:.4f} ms/batch on the host, with "
          f"pinned copies {copy_ms:.4f} ms/batch; eval step {step_ms:.4f} ms/batch of which "
          f"p_mpjpe_per_sample {p2_ms:.4f} ms  [{card}]")
    logging.getLogger().handlers.clear()
    shutil.rmtree(exp)
    return counts

# ---------------------------------------------------------------------------
# The implicit family (phases 12-16)
# ---------------------------------------------------------------------------


def seeded_igcn(basis, dev, gen, **solver):
    """An IGCN at the config's widths with a seeded init, every term live
    (``randomize``) and running BatchNorm buffers off their init."""
    model = IGCN(basis, **solver)
    randomize(model, gen)
    with torch.no_grad():
        model.batch_norm.running_mean.add_(0.1 * torch.randn(96, generator=gen))
        model.batch_norm.running_var.mul_(0.5 + torch.rand(96, generator=gen))
    return model.to(dev)


def with_solver(model, solver: str, max_iterations: int, min_iterations: int, m: int = 5):
    out = copy.deepcopy(model)
    out.solver, out.max_iterations, out.min_iterations = solver, max_iterations, min_iterations
    out.anderson_m = m
    return out


def backbone_flops(w, batch: int) -> int:
    """``net_flops`` less the two ChebConvs: the L layers alone."""
    H, L, n, nnz = w["hid_dim"], w["num_layers"], w["n_pts"], w["cheb_nnz"]
    io = n * (w["c_in"] * 3 * H + H * 3 * w["c_out"]) + nnz * (H + w["c_out"])
    return net_flops(w, batch) - 2 * batch * io


def backbone_bytes(w, batch: int) -> int:
    """The stack's weights, z and tp read once, the output written once."""
    skip = ("basis", "t0k", "t0b", "t1k", "t1b", "wtp", "btp", "win", "bin", "wout", "bout",
            "chebt_ptr", "chebt_idx", "chebt_val")
    weights = sum(v.numel() * v.element_size() for k, v in w.items()
                  if isinstance(v, torch.Tensor) and k not in skip)
    return weights + 4 * batch * w["hid_dim"] * (2 * w["n_pts"] + w["num_layers"])


def implicit_grads(model, draws, impl: str):
    """The first step's raw gradients (before the clip) of the fused or the
    module training forward on ``draws``; the model is not moved (a copy
    moves its BatchNorm buffers)."""
    m = copy.deepcopy(model).train()
    t = draws.t.to(torch.float32)
    if impl == "fused":
        out, _, _ = make_igcn_train_fn(m, dropout="prng")(draws.x_t, t, draws.seed)
    else:
        out, _ = m(draws.x_t, t, masks=draws.masks)
    loss = ((draws.e - out) ** 2).sum(dim=(1, 2)).mean()
    names = [k for k, _ in m.named_parameters()]
    return dict(zip(names, torch.autograd.grad(loss, list(m.parameters()))))


def implicit_kernel_phases(dev, basis, gen, g, card):
    """Phases 12-14 and the times of 16 that need no runner; returns the
    row-3 record without its launches, and the context of the times."""
    model = seeded_igcn(basis, dev, gen).eval()
    w = prepare_weights(model)
    err = 0.0

    # 12. row 3 against its plain version
    inputs = {}
    with torch.no_grad():
        for bsz in ROW3_BATCHES:
            z = torch.randn((bsz, 17, 96), generator=g, device=dev)
            tp = timestep_projections(w, torch.full((bsz,), float(IMPLICIT_T), device=dev))
            got = _launch_backbone(w, z, tp)
            torch.cuda.synchronize()
            e_plain = max_err(got, backbone_plain(w, z, tp))
            print(f"backbone B={bsz:5d}: max|kernel-plain| {e_plain:.3e}  |out| max "
                  f"{float(got.abs().max()):.3f}")
            check(e_plain <= TOL_KERNEL and bool(torch.isfinite(got).all()), f"row 3 B={bsz}")
            err = max(err, e_plain)
            inputs[bsz] = (z, tp)

    # 13. the eval solve against its plain twin
    x = torch.randn((IMPLICIT_BATCH, 17, 5), generator=g, device=dev)
    t = torch.full((IMPLICIT_BATCH,), float(IMPLICIT_T), device=dev)
    bn = bn_state(model)
    for solver, k in STABLE_SOLVES:
        m = with_solver(model, solver, k, k)
        fused_backbone.launches = 0
        out, aux = make_igcn_fn(m)(w, bn, x, t)
        torch.cuda.synchronize()
        want_launches = k + (solver == "anderson")
        check(fused_backbone.launches == want_launches,
              f"{solver} {k}/{k}: {fused_backbone.launches} row-3 launches, expected {want_launches}")
        out_p, aux_p = make_igcn_fn(m, backbone=backbone_plain)(w, bn, x, t)
        e_out, e_fp = max_err(out, out_p), max_err(aux["fixed_point"], aux_p["fixed_point"])
        print(f"eval solve {solver} {k}/{k} B={IMPLICIT_BATCH}: max|fused-plain| out {e_out:.3e} "
              f"fixed point {e_fp:.3e}  iterations {aux['iterations']} / {aux_p['iterations']}")
        check(e_out <= TOL_PIPELINE and e_fp <= TOL_PIPELINE and bool(torch.isfinite(out).all()),
              f"eval solve {solver} {k}/{k} against its plain twin")
    fn, plain = make_igcn_fn(model), make_igcn_fn(model, backbone=backbone_plain)
    fused_backbone.launches = 0
    out, aux = fn(w, bn, x, t)
    torch.cuda.synchronize()
    check(fused_backbone.launches == 1 + aux["iterations"], "row-3 launches of the config's solve")
    out_p, aux_p = plain(w, bn, x, t)
    # the same solve in float64 (the timestep MLP stays float32, as t is exact)
    w64 = {k: (v.double() if isinstance(v, torch.Tensor) and v.is_floating_point() else v)
           for k, v in w.items()}
    bn64, tp64 = {k: v.double() for k, v in bn.items()}, timestep_projections(w, t).double()
    z64, _, _ = model.solve(lambda zz: (bn_eval(backbone_plain(w64, zz, tp64), bn64), None),
                            _cheb(x.double(), w64["win"], w64["bin"], w64["basis"]),
                            model.tolerance, differentiable=False)
    out64 = _cheb(z64, w64["wout"], w64["bout"], w64["basis"])
    print(f"eval solve at the config (Anderson 20/10, tol 0.1): iterations fused {aux['iterations']} "
          f"plain {aux_p['iterations']}, residuals {float(aux['residual']):.5f} / "
          f"{float(aux_p['residual']):.5f}; max|fused-plain| {max_err(out, out_p):.3e}; the float32 "
          f"plain solve against float64: {float((out_p.double() - out64).abs().max()):.3e} "
          f"(|out| max {float(out64.abs().max()):.3f})")
    if aux["iterations"] != aux_p["iterations"]:
        print("  the iteration counts differ: full-history Anderson amplifies rounding, so the two "
              "residuals cross the tolerance at different iterations")
    check(tuple(out.shape) == (IMPLICIT_BATCH, 17, 5) and bool(torch.isfinite(out).all()),
          "the config's eval solve: shape or non-finite values")

    # 14. the fused implicit train step against the module step
    from diffpose_tpu_torch.data.synthetic import make_synthetic_dataset as synth

    data = synth(num_frames=IMPLICIT_STEPS * IMPLICIT_BATCH, seed=SEED + 2)
    data = {"poses_3d": torch.as_tensor(data.poses_3d, device=dev),
            "poses_2d_gmm": torch.as_tensor(data.poses_2d_gmm, device=dev)}
    batches = [{k: v[i * IMPLICIT_BATCH:(i + 1) * IMPLICIT_BATCH] for k, v in data.items()}
               for i in range(IMPLICIT_STEPS)]
    train_ctx = {}
    for solver, mx, mn, hist, held in TRAIN_SOLVES:
        base = with_solver(model, solver, mx, mn, hist).train()
        runs = {}
        for impl in ("fused", "module"):
            mm = copy.deepcopy(base)
            opt = make_optimizer(mm.parameters(), lr=TRAIN_LR)
            state = TrainState.create(mm, opt, ema_register(mm))
            step = make_implicit_train_step(mm, opt, BETAS, impl=impl, dropout="prng")
            gd = torch.Generator(device=dev).manual_seed(SEED + 3)
            draws = [step.draw(b, gd) for b in batches]
            ft.stack_fwd_prng.launches = ft.stack_bwd_prng.launches = 0
            metrics, bns = [], []
            for d in draws:
                state, met = step.apply(state, d)
                metrics.append({k: float(v) for k, v in met.items()})
                bns.append({k: getattr(mm.batch_norm, k).clone() for k in ("running_mean", "running_var")})
            torch.cuda.synchronize()
            if impl == "fused":
                # Anderson's last f(z) reaches nothing the loss reads: no backward
                per_step = (mx + (solver == "anderson"), mx)
                got = (ft.stack_fwd_prng.launches, ft.stack_bwd_prng.launches)
                check(got == tuple(IMPLICIT_STEPS * c for c in per_step),
                      f"{solver} {mx}/{mn}: seeded launches {got} over {IMPLICIT_STEPS} steps")
                train_ctx.setdefault("draws", draws)
            runs[impl] = (metrics, bns, draws[0])
        (mf, bf, df), (mm_, bm, dm) = runs["fused"], runs["module"]
        rel = [abs(a["loss"] - b["loss"]) / abs(b["loss"]) for a, b in zip(mf, mm_)]
        dbn = max(max_err(bf[0][k], bm[0][k]) for k in bf[0])
        # the same first draw: the fused step's seed, the module's masks of that seed
        gf = implicit_grads(base, df, "fused")
        gm = implicit_grads(base, dm, "module")
        finite = all(bool(torch.isfinite(v).all()) for v in (*gf.values(), *gm.values()))
        nf = float(torch.sqrt(sum((v.double() ** 2).sum() for v in gf.values())))
        nm = float(torch.sqrt(sum((v.double() ** 2).sum() for v in gm.values())))
        print(f"implicit step {solver} {mx}/{mn} m={hist} fused vs module, {IMPLICIT_STEPS} steps: rel loss "
              + " ".join(f"{v:.2e}" for v in rel) + f"  BN after step 1 {dbn:.2e}  iterations "
              f"{[m['fp_iterations'] for m in mf]} / {[m['fp_iterations'] for m in mm_]}  first-step "
              f"gradient norms (float64) {nf:.4e} / {nm:.4e}, finite {finite}")
        check(finite, f"{solver} {mx}/{mn}: non-finite gradients")
        if held == "norms":
            check(1 / GRAD_NORM_RATIO < nf / nm < GRAD_NORM_RATIO,
                  f"full-history Anderson {mx}/{mn} m={hist}: gradient norms {nf} / {nm}")
        elif held == "entries":
            # The key projection's bias has a gradient of 0 (softmax ignores a
            # shift of every score of a row): what both give there is rounding
            # noise, which at these gradient scales passes GRAD_ABS.
            zero = [k for k in gf if k.endswith("self_attn.linears.1.bias")]
            top = max(float(v.abs().max()) for v in gm.values())
            noise = max(float(g[k].abs().max()) for g in (gf, gm) for k in zero) / top
            worst = max((grad_close(gf[k], gm[k]), k) for k in gf if k not in zero)
            print(f"  worst first-step gradient rel err {worst[0]:.1e} ({worst[1]}); the key "
                  f"biases' (0 in exact arithmetic) up to {noise:.1e} of the largest entry")
            check(noise < GRAD_REL, f"{solver} {mx}/{mn}: the key biases' gradients are not noise")
            check(max(rel) <= TOL_STEP_LOSS and dbn <= TOL_BN and worst[0] < GRAD_REL,
                  f"{solver} {mx}/{mn}: fused step against the module step")

    # 16 (kernel part). times
    times = {}
    with torch.no_grad():
        for bsz in ROW3_BATCHES[:2]:
            z, tp = inputs[bsz]
            ms = time_ms(lambda: _launch_backbone(w, z, tp))
            plain_ms = time_ms(lambda: backbone_plain(w, z, tp), reps=3)
            fl, by = backbone_flops(w, bsz), backbone_bytes(w, bsz)
            bms, bwhat = bound_of(fl, by)
            times[bsz] = (ms, plain_ms, bms, bwhat)
            print(f"backbone B={bsz}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bms:.4f} ms "
                  f"({bwhat}; {fl / 1e9:.2f} GFLOP, {by / 1e6:.1f} MB)  {fl / ms / 1e9:.1f} TFLOP/s  [{card}]")
        iters = []
        def solve_once():
            iters.append(fn(w, bn, x, t)[1]["iterations"])
        solve_ms = time_ms(solve_once, reps=3, runs=5)
        print(f"eval solve (make_igcn_fn) B={IMPLICIT_BATCH}: {solve_ms:.4f} ms a batch, mean "
              f"iterations {statistics.mean(iters):.2f} ({1 + statistics.mean(iters):.2f} launches), "
              f"{IMPLICIT_BATCH / solve_ms * 1e3:.1f} frames/s  [{card}]")

    # the train step by parts (Anderson 20/10, prng, B=512)
    mm = copy.deepcopy(model).train()
    opt = make_optimizer(mm.parameters(), lr=TRAIN_LR)
    state = TrainState.create(mm, opt, ema_register(mm))
    step = make_implicit_train_step(mm, opt, BETAS, impl="fused", dropout="prng")
    d = train_ctx["draws"][0]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step_ms = time_ms(lambda: step.apply(state, d), reps=2, runs=3)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    wt = prepare_weights(mm)
    z, tp = inputs[IMPLICIT_BATCH]
    seed = d.seed
    ikeep = ft._inv_keep(None)
    drop = ft._seeded(seed, None)
    st = ft._launch_fwd(wt, z, tp, drop, ikeep)[1]
    dd5 = torch.randn_like(z)
    ds = ft._launch_bwd(wt, drop, st, dd5, ikeep)[2]
    fwd_ms = time_ms(lambda: ft._launch_fwd(wt, z, tp, drop, ikeep))
    bwd_ms = time_ms(lambda: ft._launch_bwd(wt, drop, st, dd5, ikeep))
    wg_ms = time_ms(lambda: ft.weight_grads(wt, st, ds))
    n = model.max_iterations           # 1 + n forward launches, n backward and weight_grads
    rest = step_ms - (n + 1) * fwd_ms - n * (bwd_ms + wg_ms)
    print(f"implicit train step B={IMPLICIT_BATCH} (Anderson 20/10, prng, draws given): "
          f"{step_ms:.4f} ms, {IMPLICIT_BATCH / step_ms * 1e3:.1f} frames/s, peak memory "
          f"{peak_gb:.2f} GB  [{card}]")
    print(f"  parts: {n + 1} forward kernels {(n + 1) * fwd_ms:.4f} ({fwd_ms:.4f} each)  {n} backward kernels "
          f"{n * bwd_ms:.4f} ({bwd_ms:.4f})  {n} weight_grads {n * wg_ms:.4f} ({wg_ms:.4f})  "
          f"rest {rest:.4f} ms")
    if "--profile" in sys.argv[1:]:
        profile_fused_step((state, step), d, steps=2)
    ms, plain_ms, bms, bwhat = times[IMPLICIT_BATCH]
    record = dict(name="net_kernel[backbone]", route="cuda",
                  source="diffpose_tpu_torch/csrc/net_kernel.cu",
                  replaces="diffpose_tpu/ops/pallas_denoiser.py:276", max_abs_err=err, ms=ms,
                  plain_ms=plain_ms, bound_ms=bms, bound_by=bwhat, library_ms=None,
                  batch=IMPLICIT_BATCH, ms_b1024=times[ROW3_BATCHES[1]][0],
                  bound_ms_b1024=times[ROW3_BATCHES[1]][2])
    return record


def implicit_cli_phases(card):
    """Phases 15-16: ``cli.main_implicit`` in process at the config's widths:
    train 2 epochs, resume for a third, evaluate the checkpoint; then the
    implicit runner's times.  Returns the launch counts of the training run."""
    from diffpose_tpu_torch.cli import main_implicit
    from diffpose_tpu_torch.models.convert import load_torch_states
    from diffpose_tpu_torch.train.implicit_runner import ImplicitRunner

    exp = Path(tempfile.mkdtemp(prefix="chip_smoke_implicit_"))
    b = IMPLICIT_BATCH
    steps_per_epoch = -(-IMPLICIT_FRAMES // b)
    eval_batches = -(-(IMPLICIT_FRAMES // 4) // b)
    common = ["--config", IMPLICIT_CONFIG, "--exp", str(exp), "--ni", "--use_implicit",
              "--synthetic_frames", str(IMPLICIT_FRAMES), "--batch_size", str(b),
              "--denoiser_impl", "fused"]
    train = common + ["--doc", "run", "--train", "--train_impl", "fused", "--dropout_impl", "prng"]
    run = exp / "run"
    per_step = (1 + 20, 20)       # forward, backward launches of an Anderson 20 step

    def eval_iterations(path: Path):
        """The mean iterations of every evaluation the runner logged."""
        return [float(v) for v in re.findall(r"mean fp iterations: ([0-9.]+)", path.read_text())]

    # 15. train, resume, eval-only
    reset_launch_counts()
    check(main_implicit.main(train + ["--n_epochs", "2"]) == 0, "the implicit CLI training run failed")
    torch.cuda.synchronize()
    counts = launch_counts()
    means = eval_iterations(run / "stdout.txt")
    want = {"lifter": 2 * eval_batches, "denoiser": 0,
            "backbone": round(sum(eval_batches * (1 + v) for v in means)),
            "fwd": 0, "bwd": 0, "fwd_prng": 2 * steps_per_epoch * per_step[0],
            "bwd_prng": 2 * steps_per_epoch * per_step[1]}
    print(f"main path (implicit CLI: 2 epochs of {steps_per_epoch} steps, {eval_batches} eval "
          f"batches each, mean iterations {means}) launches: {counts}")
    check(len(means) == 2 and counts == want, f"implicit CLI launches {counts}, expected {want}")
    check(main_implicit.main(train + ["--n_epochs", "3", "--resume"]) == 0,
          "the implicit CLI resume failed")
    log = (run / "stdout.txt").read_text()
    check(f"resumed from step {2 * steps_per_epoch} (epoch 2)" in log, "the resume was not logged")
    check(log.count("| Epoch 00") == 3, "the resumed run did not train exactly one more epoch")
    rows = [line.split("\t") for line in (run / "log.tsv").read_text().splitlines()[1:]]
    losses = [float(r[2]) for r in rows]
    print(f"implicit CLI log.tsv: {len(rows)} rows, epoch losses {losses}, P1 "
          f"{[float(r[3]) for r in rows]}")
    check(len(rows) == 3 and all(v == v and abs(v) != float("inf") for v in losses),
          f"implicit log.tsv rows or losses: {rows}")
    last = 3 * steps_per_epoch
    files = sorted(f.name for f in run.iterdir())
    for name in ("config.yml", "stdout.txt", "log.tsv", f"ckpt_{last:08d}.pth",
                 f"ckpt_{last:08d}.pose.pth"):
        check(name in files, f"{name} missing from the implicit run's folder: {files}")
    saved = load_torch_states(str(run / f"ckpt_{last:08d}.pth"))[0]
    moved = float((saved["batch_norm.running_var"] - 1).abs().max())
    print(f"checkpoint: batch_norm.running_var moved by up to {moved:.4f} from its init")
    check(moved > 0, "the checkpoint's BatchNorm buffers did not move")

    reset_launch_counts()
    check(main_implicit.main(common + [
        "--doc", "evalonly", "--track_metrics",
        "--model_diff_path", str(run / f"ckpt_{last:08d}.pth"),
        "--model_pose_path", str(run / f"ckpt_{last:08d}.pose.pth")]) == 0,
        "the implicit CLI eval run failed")
    e_counts = launch_counts()
    e_means = eval_iterations(exp / "evalonly" / "stdout.txt")
    check(e_counts == dict(want, lifter=eval_batches,
                           backbone=round(eval_batches * (1 + e_means[0])), fwd_prng=0, bwd_prng=0),
          f"implicit CLI eval-only launches {e_counts}")
    trained = logged_errors(run / "stdout.txt")[-1]
    alone = logged_errors(exp / "evalonly" / "stdout.txt")[-1]
    print(f"implicit eval-only from the checkpoint: P1/P2 {alone} mm, the training run's last "
          f"epoch {trained} mm")
    check(max(abs(a - c) for a, c in zip(trained, alone)) <= 1e-3,
          "implicit eval-only from the checkpoint disagrees with the training run's last eval")

    # 16. the implicit runner's times
    args = main_implicit.parse_args(train + ["--doc", "times", "--n_epochs", "3"])
    from diffpose_tpu_torch.cli.common import setup_experiment

    config = setup_experiment(args)
    runner = ImplicitRunner(config, seed=args.seed, log_dir=None, denoiser_impl="fused",
                            train_impl="fused", dropout_impl="prng")
    runner.create_diffusion_model()
    runner.create_pose_model()
    runner.set_data(make_synthetic_dataset(IMPLICIT_FRAMES, seed=args.seed),
                    make_synthetic_dataset(IMPLICIT_FRAMES // 4, seed=args.seed + 1))
    runner.train()
    secs = runner.train_seconds
    for turn in (1, 2):              # train() has evaluated after each epoch already
        runner.evaluate(is_train=True)
        print(f"implicit runner eval after training, call {turn} (fused, tt={config.testing.test_times}, "
              f"iterations {runner.fp_iterations}, seconds a batch "
              f"{[round(v, 4) for v in runner.inference_times]}): {runner.throughput_stats()}  "
              f"[{card}]")
    print(f"implicit runner train epochs of {IMPLICIT_FRAMES} frames at B={b} (fused, prng): "
          + " ".join(f"{v:.4f}" for v in secs)
          + f" s; last epoch {IMPLICIT_FRAMES / secs[-1]:.1f} frames/s  [{card}]")

    # one eval batch by parts: the step on a batch on the card, its lift and
    # GMM draw, its solve, its Procrustes metric
    dev = runner.device
    eval_fn = runner._get_implicit_eval_fn(False)
    prepared = eval_fn.prepare(runner.state, runner.pose_params)
    batch = next(iter(prefetch_to_device(runner._make_loader(runner.test_data, shuffle=False)
                                         .epoch(0), size=1, device=dev)))
    step_ms = time_ms(lambda: eval_fn(runner.state, runner.pose_params, batch, None,
                                      prepared=prepared), reps=3, runs=5)
    pred, target = torch.randn(2, b, 17, 3, device=dev).unbind(0)
    p2_ms = time_ms(lambda: p_mpjpe_per_sample(pred, target), reps=5)
    print(f"implicit runner layers at B={b}: eval step {step_ms:.4f} ms/batch (solve, lift, GMM "
          f"draw, metrics) of which p_mpjpe_per_sample {p2_ms:.4f} ms  [{card}]")
    logging.getLogger().handlers.clear()
    shutil.rmtree(exp)
    return counts


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")

    # 1. build
    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(libs)}")
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")

    # 2. models with seeded weights, and each kernel against its plain version
    torch.manual_seed(SEED)
    gen = torch.Generator().manual_seed(SEED)
    basis = cheb_basis_from_edges(17, H36M_EDGES)
    pose, diff = GCNPose(basis), GCNDiff(basis)
    randomize(pose, gen)
    randomize(diff, gen)
    pose, diff = pose.to(dev).eval(), diff.to(dev).eval()
    wp, wd = prepare_weights(pose), prepare_weights(diff)
    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev)

    errs = {"lifter": 0.0, "denoiser": 0.0}
    inputs = {}
    with torch.no_grad():
        for bsz in (BATCH, 1000):
            x = randn(bsz, 17, 2)
            got = _launch(wp, x, None)
            torch.cuda.synchronize()
            e_plain = max_err(got, net_plain(wp, x))
            e_mod = max_err(got, pose(x))
            print(f"lifter   B={bsz:5d}: max|kernel-plain| {e_plain:.3e}  max|kernel-module| {e_mod:.3e}")
            check(e_plain <= TOL_KERNEL and e_mod <= TOL_KERNEL, f"lifter B={bsz}")
            errs["lifter"] = max(errs["lifter"], e_plain)
            inputs.setdefault("lifter", (x, None))
        for bsz in (BATCH, BATCH * 5):
            x = randn(bsz, 17, 5)
            for tval in SEQ:
                t = torch.full((bsz,), float(tval), device=dev)
                tp = timestep_projections(wd, t)
                got = _launch(wd, x, tp)
                torch.cuda.synchronize()
                e_plain = max_err(got, net_plain(wd, x, tp))
                e_mod = max_err(got, diff(x, t))
                print(f"denoiser B={bsz:5d} t={tval:2d}: max|kernel-plain| {e_plain:.3e}  "
                      f"max|kernel-module| {e_mod:.3e}")
                check(e_plain <= TOL_KERNEL and e_mod <= TOL_KERNEL, f"denoiser B={bsz} t={tval}")
                errs["denoiser"] = max(errs["denoiser"], e_plain)
                inputs.setdefault(("denoiser", bsz), (x, tp))

        # 3. the main path: make_eval_fn at tt 1 and 5, counted
        x2d = randn(BATCH, 17, 2)
        evals = {tt: make_eval_fn(basis, seq=SEQ, betas=BETAS, test_times=tt) for tt in TEST_TIMES}
        fused_lifter.launches = 0
        fused_denoiser.launches = 0
        outs = {}
        for i, tt in enumerate(TEST_TIMES, start=1):
            outs[tt] = evals[tt](wp, wd, x2d)
            torch.cuda.synchronize()
            check((fused_lifter.launches, fused_denoiser.launches) == (i, 2 * i),
                  f"launch counts after eval {i}: lifter {fused_lifter.launches}, "
                  f"denoiser {fused_denoiser.launches}")
        launches = {"lifter": fused_lifter.launches, "denoiser": fused_denoiser.launches}
        print(f"main path launches: {launches}")
        for tt, out in outs.items():
            check(tuple(out.shape) == (BATCH, 17, 3) and bool(torch.isfinite(out).all()),
                  f"eval tt={tt} output shape {tuple(out.shape)} or non-finite values")
            pipe = functools.partial(lift_and_denoise, x2d=x2d, seq=SEQ, betas=BETAS, test_times=tt)
            plain = pipe(functools.partial(lifter_plain, wp), functools.partial(denoiser_plain, wd))
            module = pipe(pose, diff)
            e_plain, e_mod = max_err(out, plain), max_err(out, module)
            print(f"eval tt={tt}: max|kernel-plain| {e_plain:.3e}  max|kernel-module| {e_mod:.3e}  "
                  f"|xyz| max {float(out.abs().max()):.3f}")
            check(e_plain <= TOL_PIPELINE and e_mod <= TOL_PIPELINE, f"eval tt={tt}")

        # 4. times
        kernels = []
        x, _ = inputs["lifter"]
        ms = time_ms(lambda: _launch(wp, x, None))
        plain_ms = time_ms(lambda: net_plain(wp, x))
        bms, by = bound_ms(wp, BATCH)
        print(f"lifter   B={BATCH}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bms:.4f} ms ({by})")
        kernels.append(dict(
            name="net_kernel[lifter]", route="cuda", source="diffpose_tpu_torch/csrc/net_kernel.cu",
            replaces="diffpose_tpu/ops/pallas_denoiser.py:276", launches=launches["lifter"],
            max_abs_err=errs["lifter"], ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            library_ms=None, batch=BATCH))
        for bsz in (BATCH, BATCH * 5):
            x, tp = inputs[("denoiser", bsz)]
            ms = time_ms(lambda: _launch(wd, x, tp))
            plain_ms = time_ms(lambda: net_plain(wd, x, tp))
            bms, by = bound_ms(wd, bsz)
            print(f"denoiser B={bsz}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                  f"bound {bms:.4f} ms ({by})  {net_flops(wd, bsz) / ms / 1e9:.1f} TFLOP/s")
            if bsz == BATCH:
                kernels.append(dict(
                    name="net_kernel[denoiser]", route="cuda",
                    source="diffpose_tpu_torch/csrc/net_kernel.cu",
                    replaces="diffpose_tpu/ops/pallas_denoiser.py:276",
                    launches=launches["denoiser"], max_abs_err=errs["denoiser"], ms=ms,
                    plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None, batch=bsz))
        for tt in TEST_TIMES:
            ms = time_ms(lambda: evals[tt](wp, wd, x2d), reps=5)
            pipe = functools.partial(lift_and_denoise, x2d=x2d, seq=SEQ, betas=BETAS, test_times=tt)
            plain_ms = time_ms(lambda: pipe(functools.partial(lifter_plain, wp),
                                            functools.partial(denoiser_plain, wd)), reps=3)
            print(f"eval b={BATCH} tt={tt}: {ms:.4f} ms, {BATCH / ms * 1e3:.1f} frames/s "
                  f"(plain pipeline {plain_ms:.4f} ms, {BATCH / plain_ms * 1e3:.1f} frames/s)")

    ctx, train_records = train_phases(dev, basis, diff, g)
    kernels += train_records
    card = card_line()
    prng_records = prng_phases(dev, diff, g, ctx, card)
    cli_counts = cli_phases(card)

    backbone_record = implicit_kernel_phases(dev, basis, gen, g, card)
    implicit_counts = implicit_cli_phases(card)
    for rec, key in zip(prng_records, ("fwd_prng", "bwd_prng")):
        kernels.append(dict(rec, launches=cli_counts[key], implicit_launches=implicit_counts[key]))
    kernels.insert(2, dict(backbone_record, launches=implicit_counts["backbone"]))

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
