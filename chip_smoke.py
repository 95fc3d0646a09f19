#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's frame eval and training paths on one GPU and check them.

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
   EMA, whole fused, plain and module steps.

The line before the last holds the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import copy
import functools
import json
import statistics
import subprocess
import sys
import time

import torch

from diffpose_tpu_torch.data.synthetic import make_synthetic_dataset
from diffpose_tpu_torch.diffusion import get_beta_schedule
from diffpose_tpu_torch.graph import H36M_EDGES, cheb_basis_from_edges
from diffpose_tpu_torch.models import GCNDiff, GCNPose
from diffpose_tpu_torch.ops import _build
from diffpose_tpu_torch.ops.fused_denoiser import (
    _launch,
    denoiser_plain,
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
from diffpose_tpu_torch.ops.train_ref import layers_forward, make_dropout_masks
from diffpose_tpu_torch.models.ema import ema_register, ema_update
from diffpose_tpu_torch.train.optim import make_optimizer
from diffpose_tpu_torch.train.state import TrainState
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
TRAIN_STEPS = 20
TRAIN_FRAMES = 8192
FAST_STEPS = 25
TRAIN_LR = 2e-5
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

    def fresh(impl, lr=TRAIN_LR):
        model = copy.deepcopy(diff).train()
        opt = make_optimizer(model.parameters(), lr=lr)
        state = TrainState.create(model, opt, ema_register(model))
        return state, make_train_step(model, opt, BETAS, impl=impl, ema_mu=0.999)

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
    return [
        dict(name="train_kernel[fwd]", replaces="diffpose_tpu/ops/pallas_train.py:215",
             launches=launches["fwd"], max_abs_err=errs["fwd"], ms=fwd_ms, plain_ms=plain_fwd_ms,
             bound_ms=f_bound, bound_by=f_by_what, **common),
        dict(name="train_kernel[bwd]", replaces="diffpose_tpu/ops/pallas_train.py:531",
             launches=launches["bwd"], max_abs_err=errs["bwd"], ms=bwd_ms, plain_ms=plain_bwd_ms,
             bound_ms=b_bound, bound_by=b_by_what, **common),
    ]


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

    kernels += train_phases(dev, basis, diff, g)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
