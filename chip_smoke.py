#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one GPU and check it: for the frame, implicit
and video families the eval and training functions, every kernel, and the
command line over the runner; the standalone GraFormer's eval forward; the
two probes; the three families' sharded steps and command lines over
``torch.distributed``, and the port's multi-rank dry run.

Run from the root of a checkout, on a host with one NVIDIA H100:

    python3 chip_smoke.py            # add --profile for the fused step's kernels by device time

Phases (each fails loudly; none catches its own failure):

1. build every CUDA source under ``diffpose_tpu_torch/csrc`` (one nvcc per
   source, all at once, the tiers' libraries too) into ``build/``; fail if
   ptxas reports a spill in any train kernel, any build of
   ``net_forward_kernel`` (rows 1-3 at every tier and the probe's six) or
   rows 9-10 at every tier; print their registers and the dynamic shared
   memory of rows 1-3 and 9; build rows 9-10 once more with clock stamps
   (``probes/video_phases.py``);
2. hold each kernel against its plain PyTorch version, on the card, at
   full width (hid 96, 5 layers, 4 heads, 17 joints) with seeded weights:
   the lifter and the denoiser (t in {0, 12}) at B=1024, a ragged B=1000
   and 5120; bound 5e-5;
3. run the eval path (GCNPose lift + 2-step DDIM with GCNDiff, seq (0, 12),
   51 linear betas 1e-4..1e-3, b=1024) at test_times 1 and 5 through
   ``make_eval_fn``, count the kernel launches (1 lifter + 2 denoiser per
   call) and compare with the same pipeline over the plain versions and
   over the nn.Module forwards; bound 2e-4;
4. time each kernel, its plain version and the eval call with CUDA events
   (warmed up, median of several runs); rows 1-2 beside their bound (the
   channel products at the TF32 tensor-core peak, three passes, the rest at
   FP32) and the FP32-only bound of the earlier design;
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
   EMA, whole fused, plain and module steps; each train kernel beside its
   bound (the channel products at the TF32 tensor-core peak, three passes,
   the rest at FP32) and the FP32-only bound of the earlier design;
8. hold the seeded-dropout kernel pair (masks drawn in the kernels with
   Philox from a step seed) against its plain version, B=1024 and 1000: the
   masks the forward dumps equal ``ops/philox.py:philox_masks`` bit for bit,
   keep rates within 0.01 of 0.9 / 0.75 / 0.9, one seed gives one mask set and
   two seeds two; forward output and stashes within 5e-5 of ``layers_forward``
   over those masks; the backward, given no masks, within the limits of
   phase 5 of ``stack_bwd_plain`` over them;
9. time the seeded pair beside the explicit-mask pair, turn by turn, beside
   both bounds, and the fused step with ``dropout="prng"`` beside
   ``"masks"``;
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
    amplify rounding (Anderson 5/5, its history not yet full; damped 20/20),
    on 5 seeds of the weights and the input: output within 2e-4, the fixed
    point within 2e-4 at seed 0 and within the larger of 2e-4 and the plain
    twin's own card-to-host spread at the others (see STABLE_SEEDS), both
    printed; then at the config's solver, print
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
    (Anderson's last f(z) reaches nothing the loss reads); print the damped
    20/10 first-step gradients' worst error on 6 more seeds (finite), beside
    the module on the card against the module on the host;
15. run ``diffpose_tpu_torch.cli.main_implicit --use_implicit`` in process,
    ``configs/human36m_ipose.yml``, 4096 synthetic frames, B=512,
    ``--train_impl fused --dropout_impl prng --denoiser_impl fused``: train 2
    epochs, resume for a third, evaluate the checkpoint: launch counts (1
    lifter and 1 + iterations row-3 launches an eval batch, 21 seeded
    forward and 20 seeded backward launches a step, none of the explicit
    pair or the denoiser), files,
    finite losses, moved BatchNorm buffers, eval-only P1/P2 equal to the
    last epoch's;
16. time row 3 at B=512 and 1024 (both bounds), the eval solve, the train
    step by parts, rows 5-8 at B=512 (both bounds) and the implicit runner
    (train epochs, ``throughput_stats()``).

The video (spatio-temporal) family, at the width of
``configs/human36m_video.yml`` (hid 96, 4 heads, 17 joints, 81-frame
windows, 4 layers, video dropout 0.1, 16 windows a batch, 2-step DDIM) with a
seeded init:

17. hold kernel row 10 (``fused_temporal_layer``, one TemporalBlock) against
    ``temporal_layer_plain`` and row 9 (``fused_st_layer``, one whole video
    layer in a cooperative launch) against ``st_layer_plain`` at 16 windows of
    81 frames, a ragged 5 windows and 2 windows of 243 frames; bound 5e-5;
    print both kernels' occupancy, each phase's work items and waves at
    every shape (fail if at 16 x 81 the tiles of T1 and T3 are fewer than
    the co-resident CTAs or T2's warp tasks fewer than their warps), and
    block 0's ``clock64`` cycles by phase (``probes/video_phases.py``);
18. hold the three fused eval forwards (``make_video_denoiser_fn`` with torch
    and with kernel temporal blocks, ``make_video_full_fn``) against the
    module at B=16, with their launches (4 row-3; 4 row-3 + 4 row-10; 4
    row-9 a call), and the eval step with each against the module's step;
    bound 2e-4;
19. hold the fused video train function at rates 0 against the module's
    autograd (output 5e-5, gradients entry by entry, the key biases' noise
    apart), then 3 fused steps against 3 plain steps on the same draws, with
    explicit masks and with seeded dropout (loss within 1e-3 relative; 4
    forward + 4 backward launches a step);
20. run ``diffpose_tpu_torch.cli.main_video`` in process with
    ``configs/human36m_video.yml``, 128 synthetic windows (8 steps an epoch,
    32 test windows, 2 eval batches), ``--train_impl fused --dropout_impl
    prng --denoiser_impl fused``: train 2 epochs (4 seeded forward + 4 seeded
    backward launches a step, 8 row-3 launches an eval batch), resume for a
    third, evaluate the checkpoint alone with ``fused``, ``fused_st`` and
    ``fused_full`` (8 row-3; 8 row-3 + 8 row-10; 8 row-9 launches an eval
    batch): files, finite losses, the three eval-only P1/P2 equal to each
    other and to the last epoch's to 1e-3 mm;
21. time rows 9 and 10 at the three shapes beside their bounds (every
    product and the attention at TF32) and FP32-only bounds, row 3 at 1,296 rows
    and 1 layer (both bounds), plain
    versions and, for row 10, ``scaled_dot_product_attention`` on its q/k/v
    and the block from library calls; the inner eval call and the eval step
    of each impl; the fused train step by parts, rows 5-8 at 1,296 rows and
    1 layer (both bounds); the video runner (train epochs,
    ``throughput_stats()`` per impl).

The standalone GraFormer (hid 128, 4 layers, 4 heads, 21 points, ``GAN_EDGES``,
seeded init) and the probes:

22. hold ``make_graformer_fn`` (every ChebConv on kernel row 4,
    ``fused_cheb_conv``) against the module at B=1024, with and without two
    joints masked (bound 2e-4; 10 row-4 launches a forward); row 4 against
    ``cheb_conv_plain`` at GraFormer's 2->128, 128->128 and 128->3 at 21
    joints (B=1024) and 17 joints (B=1000, ragged), at the video family's
    I/O shapes (1,296 rows, 5->96 and 96->5) and, untimed, at the wide
    path's other widths of ``CHEB_MORE``; bound 5e-5; the wide path's
    shapes also against its TF32 model (``cheb_conv_plain`` with
    ``matmul_3xtf32``, on the host, on ``CHEB_MODEL_SAMPLES`` samples); each
    shape's kernel (``cheb_plan``: wide, mix or proj; CTAs), ms (wrapper
    calls) and device ms (``torch.profiler``), plain and ``torch.einsum`` ms
    beside its bound (the wide path's products at the TF32 peak, three
    passes) and FP32-only bound; the kernels' ptxas registers (no spills);
    the module's and the fused forward's ms, and from ``torch.profiler``
    the device time of row 4's launches inside the fused forward and of the
    module's ChebConvs inside its own;
23. kernel row 11 (``probes/ablate.py``): the probe's SKIP = 0 build
    bit-equal to row 1's production kernel with the same ptxas resources;
    the five variants within 5e-5 of ``net_plain_ablated``; ms per variant
    at B=1024 and the share of each part;
24. kernel row 12 (``probes/batched_dot.py``): TF32 tensor-core attention,
    1x and 3x, against f32 at T=136 and 1088 (F=81, dk=24), ms and device
    ms beside ``scaled_dot_product_attention``, both bounds, the grid and
    ptxas registers (no spills); 3xTF32 within 5e-5 at both shapes; and
    ``ops/tf32.py``, the plain model of the train kernels' products, bit
    for bit equal to ``mma.sync`` (``probes/tf32_gemm.py``: one mma, a
    chain, 3xTF32 with k-step partials as ``tc_gemm`` and over the whole K).

Parallelism over ``torch.distributed`` (``diffpose_tpu_torch/parallel``), the
ranks spawned as processes of ``parallel/worker.py`` (a rank that fails
fails the run), at full width (the seeded GCNDiff and GCNPose, B=1024; a
seeded IGCN, damped 20/10, B=512):

25. a world of 1 rank over nccl: ``make_sharded_train_step`` (fused, explicit
    masks and prng) for 3 steps, ``make_sharded_eval_step`` at test_times 1
    and 5, ``make_sharded_implicit_train_step`` (fused, prng) for 3 steps and
    ``make_sharded_implicit_eval_step`` (damped 20/20) equal the unsharded
    step and eval bit for bit (an all-reduce over one rank is the identity);
    each timed sharded and unsharded on the same draws; then, on the rank,
    ``main_frame`` (``--data_parallel`` train, ``--resume``, an eval-only run
    with ``--hypothesis_parallel 1``), ``main_implicit`` and ``compare``
    with the mesh flags: return codes 0, the checkpoints saved by rank 0;
26. a world of 2 ranks over gloo, both on cuda:0 (NCCL takes one rank a
    card): 2 sharded train steps of B=512 a rank against the single-process
    step on the concatenated draws (explicit masks through the same kernels;
    each rank's Philox seed as its masks through the plain stack), within
    phase 6's limits and parameters within 2e-4; a sweep of 2 over the
    global index array; the sharded eval (data) at test_times 1 and 5 and
    on a (1, 2) data x hypothesis grid at 2 bit-equal to the single-process
    eval of each rank's slice (and share of the hypotheses) and against the
    single-process eval of the whole batch P1 and pred within 1e-6, P2 within
    1e-5; the implicit step against the mean of the per-shard steps
    (BatchNorm buffers within 1e-5); the fixed-count implicit eval (damped
    20/20) bit-equal to the single-process eval of each slice and within
    2e-4 of the whole batch's (its 150-340 fixed point amplifies the
    rounding of the torch products at another batch size); each kernel's
    launches on each rank; the command lines as in 25, the eval-only run
    with ``--hypothesis_parallel 2``, every rank's return code 0 and the
    checkpoints saved by rank 0 alone;
27. ``torchrun --standalone --nproc_per_node 1 -m
    diffpose_tpu_torch.cli.main_frame --train --data_parallel`` (nccl) for
    one epoch of 4096 synthetic frames at B=1024: rc 0, one ``log.tsv``
    row, the checkpoint written once.

The video family over ``torch.distributed`` at the width of
``configs/human36m_video.yml`` (seeded init, 16 windows of 81 frames a step):

28. a world of 1 rank over nccl on a (1, 1) data x context mesh: the fused
    train step with seeded dropout (rows 7-8, over the data axis) for 2
    steps, and the eval with ``fused`` (row 3, over both axes: the keys and
    values gathered), ``fused_st`` (rows 3 and 10) and ``fused_full`` (row
    9; both over the data axis) equal the unsharded step and eval bit for
    bit; each timed sharded and unsharded by turns, and its collectives
    alone (the train step's one ``all_reduce``, the context eval's 8
    gathers);
29. a world of 2 ranks over gloo on cuda:0, data 2 (8 windows a rank): the
    fused train step with explicit masks (rows 5-6) and with seeded dropout
    (rows 7-8) against ``worker.video_reference`` (the single-process step on
    the joined draws: the same kernels, or the plain stack over the seeds'
    masks), within phase 6's limits and parameters within 2e-4; the three
    fused evals against the single-process eval of the whole batch (P1 and
    pred within 1e-6, P2 within 1e-5); each kernel's launches on each rank;
30. a world of 3 ranks over gloo on cuda:0, context 3 (27 frames a rank, 16
    windows): the module train step (dropout 0, the keys and values gathered
    under autograd) and the fused eval (row 3 on 432 rows a launch) against
    the reference, as in 29; ``main_video --context_parallel 3`` inside that
    world (rc 0, the checkpoint by rank 0 alone); then ``torchrun
    --nproc_per_node 1 -m diffpose_tpu_torch.cli.main_video --data_parallel
    --context_parallel 1`` (nccl);
31. ``dryrun_multichip(4)`` (``diffpose_tpu_torch/dryrun.py``) over gloo on
    cuda:0: every parallel path of the three families, each held to its
    single-process reference, and its OK line.

The reduced tiers of ``--kernel_precision`` (``bf16``: one tensor-core pass
on bf16 operands, activations rounded to bf16 where the TPU kernels cast
them; ``default``: one TF32 pass), built into their own libraries
(``csrc/net_kernel_tiers.cu``, ``csrc/video_kernel_tiers.cu``) in phase 1,
the utilities and the fast eval:

32. rows 1-3 at each tier against their plain tier versions (row 1 at B=1024
    and 5120, row 2 at 1024, row 3 at 512), held to the tier's own scale
    (``TIER_MAX_SHARE``: a kernel and its plain twin round some values
    apart), each timed (median of 7) beside its one-pass bound, with ptxas'
    registers (phase 1 fails on a spill); ``make_eval_fn`` at B=1024, tt 1
    and 5, at each tier and at parity: ms and |dP1| mean and max against the
    float32 pipeline on the same seeded weights (x2d and the target
    N(0, 0.3) m, as ``scripts/probe_precision.py``); ``main_frame``
    eval-only with ``--denoiser_impl fused --kernel_precision bf16``, then
    ``default`` with ``--matmul_precision default``: only tier kernels ran;
33. rows 9 and 10 at each tier the same way at 16x81, 5x81 and 2x243, and
    row 3 at the video shape (1,296 rows, one layer); both tier kernels'
    occupancy; ``main_video`` eval-only with ``fused_st`` and ``fused_full``
    at each tier (only tier kernels ran);
34. the utilities on the card: ``device_memory_budget`` and
    ``suggest_batch_size(estimate_per_sample_bytes())`` beside the card's
    name, ``trace_profile`` around one fused eval batch inside a program
    span, whose Chrome trace must name the span and the row-1 kernel;
35. the BigW fast eval (``ops/fast_eval.py``) at B=1024 against the
    module forward, f32 within 3e-5 (``tests/test_fast_eval.py``) and in
    bf16, timed beside row 1.

Each family's wall seconds are printed.

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from diffpose_tpu_torch.data.loader import prefetch_to_device
from diffpose_tpu_torch.data.synthetic import make_synthetic_dataset
from diffpose_tpu_torch.data.video import synthetic_video_dataset
from diffpose_tpu_torch.diffusion import get_beta_schedule
from diffpose_tpu_torch.graph import GAN_EDGES, H36M_EDGES, cheb_basis_from_edges
from diffpose_tpu_torch.metrics import p_mpjpe_per_sample
from diffpose_tpu_torch.models import IGCN, GCNDiff, GCNPose, GraFormer
from diffpose_tpu_torch.models.igcn import bn_eval, bn_state
from diffpose_tpu_torch.models.layers import ChebGraphConv
from diffpose_tpu_torch.models.video import SpatioTemporalDiff
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
from diffpose_tpu_torch.ops import fused_cheb as fc
from diffpose_tpu_torch.ops import fused_train as ft
from diffpose_tpu_torch.ops.fused_graformer import make_graformer_fn
from diffpose_tpu_torch.probes import (ProfilerBlind, ablate, batched_dot, device_clock, device_ms,
                                       profiled, profiler_sees_device, tf32_gemm, time_ms,
                                       video_phases)
from diffpose_tpu_torch.ops.fused_denoiser import _cheb, _layer_norm
from diffpose_tpu_torch.ops.tf32 import TIER_CODES, matmul_3xtf32
from diffpose_tpu_torch.ops.fused_video_full import fused_st_layer, fused_temporal_layer
from diffpose_tpu_torch.ops.fused_pipeline import lift_and_denoise, make_eval_fn
from diffpose_tpu_torch.ops.philox import philox_masks
from diffpose_tpu_torch.ops.train_ref import layers_forward, make_dropout_masks
from diffpose_tpu_torch.parallel import worker
from diffpose_tpu_torch.models.ema import ema_register, ema_update
from diffpose_tpu_torch.train.optim import make_optimizer
from diffpose_tpu_torch.train.state import TrainState
from diffpose_tpu_torch.train.implicit_steps import make_implicit_train_step
from diffpose_tpu_torch.train.steps import make_draw, make_train_step, make_train_sweep_step

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
# Seeds (weights and inputs) at which phase 13 holds them: the config's model
# and input first, then four more draws of both.  The output of every solve is
# held to TOL_PIPELINE; the fixed point too at seed 0, and at the others to
# the larger of TOL_PIPELINE and the plain solve's own spread (the plain twin
# on the card against the plain twin on the host): the damped 20/20 fixed
# point grows to 150-340 in magnitude, where 2e-4 is a few float32 ulps.
STABLE_SEEDS = (0, 1, 2, 3, 4)
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
# More seeds (weights, data and dropout) of the damped 20/10 step's first-step
# gradients in phase 14, printed beside the module on the card against the
# module on the host: how far float32 rounding alone moves them at each draw.
MARGIN_SEEDS = (1, 2, 3, 4, 5, 6)
TOL_BN = 1e-5
# The video family (configs/human36m_video.yml): 16 windows of 81 frames;
# rows 9 and 10 also at a ragged 5 windows and at the published long window.
VIDEO_CONFIG = "configs/human36m_video.yml"
VIDEO_BATCH, VIDEO_FRAMES = 16, 81
VIDEO_SHAPES = ((VIDEO_FRAMES, VIDEO_BATCH), (VIDEO_FRAMES, 5), (243, 2))
VIDEO_WINDOWS = 128          # 8 steps an epoch; the CLI cuts 32 test windows, 2 eval batches
VIDEO_STEPS = 3
# The standalone GraFormer (phase 22): hid 128, 4 layers, 4 heads, 21 points
# (GAN_EDGES); row 4 also at 17 joints with a ragged batch, and at the video
# family's I/O ChebConv shapes (B·F rows).
GRAFORMER_BATCH, GRAFORMER_RAGGED = 1024, 1000
VIDEO_IO = ((5, 96), (96, 5))       # models/video.py: gconv_input, gconv_output
# Row 4's wide path at widths no model has (a partial slab and column chunk,
# several column chunks, the video's hidden width, more than one wave), held
# to cheb_conv_plain untimed: (joints, batch, C, D).
CHEB_MORE = ((21, 7, 40, 136), (17, 333, 24, 264), (17, VIDEO_BATCH * VIDEO_FRAMES, 96, 96),
             (21, 5000, 128, 128))
# Samples of a shape that the wide path's TF32 model (float64 on the host) takes.
CHEB_MODEL_SAMPLES = 8
# H100 SXM peaks (NVIDIA data sheet): FP32 on CUDA cores, dense TF32 on the
# tensor cores, HBM3.
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
PEAK_BYTES = 3.35e12
# --kernel_precision's tiers: the passes of each tensor-core product and the
# peak of their operands' type (bf16: bf16 values, one pass; default: one
# TF32 pass; bf16x3, the parity grade: three TF32 passes).
TIER_RATES = {"bf16x3": (3, PEAK_TF32), "bf16": (1, PEAK_BF16), "default": (1, PEAK_TF32)}
TIERS = ("bf16", "default")
# Phases 32-33: a tier kernel against its plain tier version on the same
# inputs.  Both round (to bf16, or to TF32 operands) values that their
# float32 sums, taken in other orders, leave a float32 ulp or so apart, and
# the tiers are chaotic in that: on the CPU a 1e-7 relative change of the
# input moves the default tier's two-layer output by a fifth of its own mean
# distance from float32 (the plain version against itself).  So the kernel is
# held to the tier's own scale: its largest difference from the plain tier
# version within TIER_MAX_SHARE of the plain tier version's largest
# difference from the float32 plain version (an output rounded the other way
# differs by a whole bf16 ulp, twice the largest rounding error), its mean
# within TIER_MEAN_SHARE of that mean, and (it did run at the tier) its mean
# distance from float32 at least TIER_FLOOR_SHARE of the plain tier's.  A
# kernel at the parity grade, or one that rounds at other places, lands near
# a mean share of 1.
TIER_MAX_SHARE, TIER_MEAN_SHARE, TIER_FLOOR_SHARE = 2.0, 0.8, 0.25
TIER_CLI_FRAMES = 4096            # the tier CLI runs' synthetic frames: one eval batch of 1024
TIER_CLI_WINDOWS = 64             # the video tier CLI runs' windows: one eval batch of 16
TOL_FAST = 3e-5                   # tests/test_fast_eval.py: the f32 fast eval against the module
# Parallelism (phases 25-27): a world of 1 rank (nccl), then of 2 ranks (gloo,
# both on cuda:0), then the command line under torchrun.
PAR_STEPS = 3                 # train steps at 1 rank; one fewer at 2
PAR_SWEEP = 2
PAR_IMPLICIT_SOLVE = ("damped", 20, 10)   # phase 14's well-conditioned train solve
PAR_IMPLICIT_EVAL_ITERS = 20              # phase 13's damped eval solve at a fixed count
PAR_CLI_FRAMES = 4096                     # 4 steps of B=1024
PAR_TIMEOUT = 300                         # seconds a world may take
PAR_VIDEO_STEPS = 2                       # video train steps in phases 28-30
TOL_VIDEO_LOSS = 1e-6                     # relative, a sharded video step's loss against the reference


def check(ok: bool, msg: str):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a.detach() - b.detach()).abs().max())


def randomize(model: torch.nn.Module, gen: torch.Generator):
    """Seeded perturbation of the parameters an init leaves trivial (identity
    adjacency, unit LayerNorm, zero ChebConv biases), so every term is live."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.endswith("A_hat"):
                p.add_(0.1 * torch.rand(p.shape, generator=gen))
            elif name.endswith(("bias", "a_2", "b_2")):
                p.add_(0.1 * torch.randn(p.shape, generator=gen))


def stack_flops(w, batch: int):
    """Multiply-adds (×2) of the L-layer stack as rows 1-3 compute it, as
    (channel products, the rest): QKV, out-projection, fc1, fc2 and the two
    residual ChebConvs' products run on the tensor cores; attention, the
    graph mixes and the LayerNorms on the CUDA cores."""
    H, L, n, nnz = w["hid_dim"], w["num_layers"], w["n_pts"], w["cheb_nnz"]
    gemm = H * 3 * H + H * H + H * 2 * H + 2 * H * H + 2 * (H * 3 * H)
    attention = 2 * n * H        # scores and value sums over n keys, all heads
    lap_mix = 2 * n * H          # two learned-adjacency mixes, H wide
    return 2 * batch * L * n * gemm, 2 * batch * L * (n * (attention + lap_mix) + 2 * nnz * H)


def net_flops_split(w, batch: int):
    """``stack_flops`` and the input and output ChebConvs (CUDA cores)."""
    H, n, nnz = w["hid_dim"], w["n_pts"], w["cheb_nnz"]
    prod, rest = stack_flops(w, batch)
    io = n * (w["c_in"] * 3 * H + H * 3 * w["c_out"]) + nnz * (H + w["c_out"])
    return prod, rest + 2 * batch * io


def net_flops(w, batch: int) -> int:
    """Multiply-adds (×2) of one forward as the kernel computes it."""
    return sum(net_flops_split(w, batch))


def weight_bytes(w, skip=()) -> int:
    """Each f32 weight once: not the TF32 parts (or a tier's rounded weights)
    the kernel reads in their place, nor the timestep MLP (outside the kernels)."""
    skip = ("basis", "t0k", "t0b", "t1k", "t1b", "wtp", "btp", *skip)
    return sum(v.numel() * v.element_size() for k, v in w.items()
               if isinstance(v, torch.Tensor) and k not in skip
               and not k.endswith(("_tf32", "_1p")))


def net_bytes(w, batch: int) -> int:
    """Inputs read once and the output written once."""
    act = batch * w["n_pts"] * (w["c_in"] + w["c_out"])
    if w["has_temb"]:
        act += w["num_layers"] * batch * w["hid_dim"]
    return weight_bytes(w, ("chebt_ptr", "chebt_idx", "chebt_val")) + 4 * act


def tf32_bounds(flops, nbytes: int, tier: str = "bf16x3"):
    """Rows 1-3's least times, ``(ms, by, fp32_ms)``: the channel products at
    the dense TF32 tensor-core peak, three passes (3xTF32; at a reduced
    ``tier`` its passes at its operands' peak, ``TIER_RATES``), the rest at
    the FP32 peak, against the bytes (``train_bounds``' rule); and every
    operation at the FP32 peak against the bytes, the bound the earlier
    CUDA-core design was given."""
    prod, rest = flops
    passes, peak = TIER_RATES[tier]
    ops_ms, bytes_ms = 1e3 * (passes * prod / peak + rest / PEAK_FP32), 1e3 * nbytes / PEAK_BYTES
    ms, by = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
    return ms, by, bound_of(prod + rest, nbytes)[0]


def bound_ms(w, batch: int, tier: str = "bf16x3"):
    """Rows 1-2 at ``batch``: ``tf32_bounds``."""
    return tf32_bounds(net_flops_split(w, batch), net_bytes(w, batch), tier)


def grad_close(got: torch.Tensor, want: torch.Tensor) -> float:
    """0 where the difference is under GRAD_ABS, else it relative to the
    reference's largest entry."""
    d = float((got - want).abs().max())
    return 0.0 if d < GRAD_ABS else d / (float(want.abs().max()) + 1e-8)


def train_flops(w, batch: int):
    """Multiply-adds (×2) of the stack forward and backward as the kernels
    compute them, as (channel products, the rest): the products run on the
    tensor cores, the rest on the CUDA cores."""
    H, L, n, nnz = w["hid_dim"], w["num_layers"], w["n_pts"], w["cheb_nnz"]
    fwd_gemm = H * 3 * H + H * H + H * 2 * H + 2 * H * H + 2 * (H * 3 * H)
    fwd_rest = n * (2 * n * H + 2 * n * H) + 2 * nnz * H
    # two transposed Chebyshev products, fc2ᵀ, fc1ᵀ, out-projᵀ, the QKV recompute, QKVᵀ
    bwd_gemm = 2 * (3 * H * H) + 2 * (2 * H * H) + H * H + 2 * (H * 3 * H)
    # scores, dp, dq, dk, dv over n keys; two transposed learned-adjacency mixes
    bwd_rest = n * (5 * n * H + 2 * n * H) + 2 * nnz * H
    return {"fwd": (2 * batch * L * n * fwd_gemm, 2 * batch * L * fwd_rest),
            "bwd": (2 * batch * L * n * bwd_gemm, 2 * batch * L * bwd_rest)}


def train_bytes(w, batch: int, masks: bool = True):
    """Inputs read once and outputs written once, forward and backward; the
    dropout masks only where the kernels read them (``masks``: rows 5-6,
    not the seeded rows 7-8)."""
    H, L, n, heads = w["hid_dim"], w["num_layers"], w["n_pts"], w["num_heads"]
    weights = 4 * sum(w[k].numel() for k in ft.STACK_KEYS)
    mask = L * batch * (heads * n * n + 4 * n * H) if masks else 0
    row = 4 * batch * n * H                      # one [B, 17, H] f32 array
    fwd = weights + mask + row + 4 * L * batch * H + row + L * row * 10     # h0, tp, d5, stashes
    bwd = weights + mask + row + L * row * 7 + row + 4 * L * batch * H + L * row * 9
    return {"fwd": fwd, "bwd": bwd}


def train_bounds(w, batch: int, tier: str = "bf16x3"):
    """Rows 5-8's least times at one shape, {(kind, masks): (ms, by, fp32_ms)}:
    the channel products at the dense TF32 tensor-core peak, three passes
    (3xTF32; at a reduced ``tier`` its passes at its operands' peak,
    ``TIER_RATES``), plus the rest at the FP32 peak, against the bytes; and,
    for comparison with the earlier design, every operation at the FP32 peak
    against the bytes with the masks counted for both pairs (the bound that
    design was given)."""
    flops, old_bytes = train_flops(w, batch), train_bytes(w, batch)
    passes, peak = TIER_RATES[tier]
    out = {}
    for masks in (True, False):
        nbytes = train_bytes(w, batch, masks)
        for kind, (prod, rest) in flops.items():
            ops_ms = 1e3 * (passes * prod / peak + rest / PEAK_FP32)
            bytes_ms = 1e3 * nbytes[kind] / PEAK_BYTES
            ms, by = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
            out[(kind, masks)] = (ms, by, bound_of(prod + rest, old_bytes[kind])[0])
    return out


def train_pair_times(w, h0, tp, seed, gen, rates, card, shape: str, tier: str = "bf16x3"):
    """Rows 5-8 at one shape (at ``tier``: that build), each launch timed turn
    by turn (explicit, seeded, seeded, explicit), beside both bounds;
    {(kind, masks): ms}."""
    L, bsz = w["num_layers"], h0.shape[0]
    ikeep = ft._inv_keep(rates)
    km = ft.kernel_masks(make_dropout_masks(gen, num_layers=L, n_pts=w["n_pts"], batch=bsz,
                                            num_heads=w["num_heads"], hid_dim=w["hid_dim"],
                                            rates=rates))
    drop = ft._seeded(seed, rates)
    st = ft._launch_fwd(w, h0, tp, drop, ikeep, tier=tier)[1]
    dd5 = torch.randn_like(h0)
    runs = {"fwd": (lambda: ft._launch_fwd(w, h0, tp, km, ikeep, tier=tier),
                    lambda: ft._launch_fwd(w, h0, tp, drop, ikeep, tier=tier)),
            "bwd": (lambda: ft._launch_bwd(w, km, st, dd5, ikeep, tier=tier),
                    lambda: ft._launch_bwd(w, drop, st, dd5, ikeep, tier=tier))}
    bounds, ms = train_bounds(w, bsz, tier), {}
    for kind, (explicit, seeded) in runs.items():
        a, b, c, d = time_ms(explicit), time_ms(seeded), time_ms(seeded), time_ms(explicit)
        ms[(kind, True)], ms[(kind, False)] = (a + d) / 2, (b + c) / 2
    for (kind, masks), t in ms.items():
        bms, by, fp32 = bounds[(kind, masks)]
        print(f"train {kind} kernel ({'masks' if masks else 'prng '}) {shape}"
              f"{'' if tier == 'bf16x3' else ' tier ' + tier}: {t:.4f} ms  bound "
              f"{bms:.4f} ms ({by}; {100 * bms / t:.1f}%)  FP32-only bound {fp32:.4f} ms "
              f"({100 * fp32 / t:.1f}%)  [{card}]")
    return ms, bounds


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
    flops, nbytes, bounds = train_flops(wt, BATCH), train_bytes(wt, BATCH), train_bounds(wt, BATCH)
    for kind, t, plain in (("fwd", fwd_ms, plain_fwd_ms), ("bwd", bwd_ms, plain_bwd_ms)):
        (prod, rest), (bms, by, fp32) = flops[kind], bounds[(kind, True)]
        print(f"train {kind} kernel B={BATCH}: {t:.4f} ms  plain {plain:.4f} ms  bound {bms:.4f} ms "
              f"({by}; {prod / 1e9:.2f} GFLOP products at 3xTF32, {rest / 1e9:.2f} GFLOP other, "
              f"{nbytes[kind] / 1e6:.1f} MB)  FP32-only bound {fp32:.4f} ms  "
              f"{(prod + rest) / t / 1e9:.1f} TFLOP/s")
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
    ctx = dict(wt=wt, kept=kept, fresh=fresh, batch_of=batch_of, bounds=bounds)
    return ctx, [
        dict(name="train_kernel[fwd]", replaces="diffpose_tpu/ops/pallas_train.py:215",
             launches=launches["fwd"], max_abs_err=errs["fwd"], ms=fwd_ms, plain_ms=plain_fwd_ms,
             **train_record_bounds(bounds, "fwd", True), **common),
        dict(name="train_kernel[bwd]", replaces="diffpose_tpu/ops/pallas_train.py:531",
             launches=launches["bwd"], max_abs_err=errs["bwd"], ms=bwd_ms, plain_ms=plain_bwd_ms,
             **train_record_bounds(bounds, "bwd", True), **common),
    ]


def train_record_bounds(bounds, kind: str, masks: bool) -> dict:
    """A row's bound keys on the kernels line: the TF32 bound, its kind and
    the FP32-only bound of the earlier design."""
    bms, by, fp32 = bounds[(kind, masks)]
    return dict(bound_ms=bms, bound_by=by, bound_ms_fp32=fp32)


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
        bms, by, fp32 = ctx["bounds"][(name, False)]
        print(f"prng {name} kernel B={BATCH}: seeded {b:.4f} {c:.4f} ms  explicit masks {a:.4f} "
              f"{d:.4f} ms  bound {bms:.4f} ms ({by}; {100 * bms / ms[name][0]:.1f}%)  FP32-only "
              f"bound {fp32:.4f} ms ({100 * fp32 / ms[name][0]:.1f}%)  [{card}]")
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
                  batch=BATCH)
    return [
        dict(name="train_kernel[fwd,prng]", replaces="diffpose_tpu/ops/pallas_train.py:314",
             max_abs_err=errs["fwd"], ms=ms["fwd"][0], explicit_masks_ms=ms["fwd"][1],
             plain_ms=philox_ms + plain_fwd, **train_record_bounds(ctx["bounds"], "fwd", False),
             **common),
        dict(name="train_kernel[bwd,prng]", replaces="diffpose_tpu/ops/pallas_train.py:581",
             max_abs_err=errs["bwd"], ms=ms["bwd"][0], explicit_masks_ms=ms["bwd"][1],
             plain_ms=philox_ms + plain_bwd, **train_record_bounds(ctx["bounds"], "bwd", False),
             **common),
    ]


def reset_launch_counts():
    for fn in (fused_lifter, fused_denoiser, fused_backbone, ft.stack_fwd, ft.stack_bwd,
               ft.stack_fwd_prng, ft.stack_bwd_prng, fused_temporal_layer, fused_st_layer):
        fn.launches = 0
    for fn in (*TIER_WRAPPERS.values(), *TRAIN_TIER_WRAPPERS.values()):
        fn.tier_launches = {t: 0 for t in TIERS}


# The wrappers of rows 1-3 and 9-10, which also count their tier launches.
TIER_WRAPPERS = {"lifter": fused_lifter, "denoiser": fused_denoiser, "backbone": fused_backbone,
                 "st": fused_st_layer, "temporal": fused_temporal_layer}


# The train kernels' wrappers (rows 5-8), which count their tier launches too.
TRAIN_TIER_WRAPPERS = {"fwd": ft.stack_fwd, "bwd": ft.stack_bwd, "fwd_prng": ft.stack_fwd_prng,
                       "bwd_prng": ft.stack_bwd_prng}


def train_tier_counts() -> dict:
    """Rows 5-8's launches by tier since ``reset_launch_counts``, the parity
    build's under ``bf16x3``."""
    return {t: {k: (fn.launches if t == "bf16x3" else fn.tier_launches[t])
                for k, fn in TRAIN_TIER_WRAPPERS.items()} for t in ("bf16x3", *TIERS)}


def tier_launch_counts() -> dict:
    """Each tier kernel's launches since ``reset_launch_counts``, by tier."""
    return {t: {k: fn.tier_launches[t] for k, fn in TIER_WRAPPERS.items()} for t in TIERS}


def launch_counts() -> dict:
    return {"lifter": fused_lifter.launches, "denoiser": fused_denoiser.launches,
            "backbone": fused_backbone.launches,
            "fwd": ft.stack_fwd.launches, "bwd": ft.stack_bwd.launches,
            "fwd_prng": ft.stack_fwd_prng.launches, "bwd_prng": ft.stack_bwd_prng.launches,
            "temporal": fused_temporal_layer.launches, "st": fused_st_layer.launches}


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
            "fwd": 0, "bwd": 0, "fwd_prng": 2 * steps_per_epoch, "bwd_prng": 2 * steps_per_epoch,
            "temporal": 0, "st": 0}
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
    return sum(stack_flops(w, batch))


def backbone_bytes(w, batch: int) -> int:
    """The stack's weights, z and tp read once, the output written once."""
    weights = weight_bytes(w, ("win", "bin", "wout", "bout", "chebt_ptr", "chebt_idx", "chebt_val"))
    return weights + 4 * batch * w["hid_dim"] * (2 * w["n_pts"] + w["num_layers"])


def backbone_bound(w, batch: int, tier: str = "bf16x3"):
    """Row 3 at ``batch``: ``tf32_bounds``."""
    return tf32_bounds(stack_flops(w, batch), backbone_bytes(w, batch), tier)


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

    # 13. the eval solve against its plain twin, on STABLE_SEEDS draws of the
    # weights and the input (their own generators: the later phases draw as before)
    x = torch.randn((IMPLICIT_BATCH, 17, 5), generator=g, device=dev)
    t = torch.full((IMPLICIT_BATCH,), float(IMPLICIT_T), device=dev)
    bn = bn_state(model)
    for seed in STABLE_SEEDS:
        if seed == 0:
            ms_model, ms_w, ms_bn, ms_x = model, w, bn, x
        else:
            with torch.random.fork_rng(devices=[]):   # the init's draws too
                torch.manual_seed(SEED + 100 + seed)
                ms_model = seeded_igcn(basis, dev,
                                       torch.Generator().manual_seed(SEED + 100 + seed)).eval()
            ms_w, ms_bn = prepare_weights(ms_model), bn_state(ms_model)
            ms_x = torch.randn((IMPLICIT_BATCH, 17, 5), device=dev,
                               generator=torch.Generator(device=dev).manual_seed(SEED + 100 + seed))
        for solver, k in STABLE_SOLVES:
            m = with_solver(ms_model, solver, k, k)
            fused_backbone.launches = 0
            out, aux = make_igcn_fn(m)(ms_w, ms_bn, ms_x, t)
            torch.cuda.synchronize()
            want_launches = k + (solver == "anderson")
            check(fused_backbone.launches == want_launches,
                  f"{solver} {k}/{k}: {fused_backbone.launches} row-3 launches, expected {want_launches}")
            out_p, aux_p = make_igcn_fn(m, backbone=backbone_plain)(ms_w, ms_bn, ms_x, t)
            e_out, e_fp = max_err(out, out_p), max_err(aux["fixed_point"], aux_p["fixed_point"])
            mh = copy.deepcopy(m).to("cpu")
            out_h, aux_h = make_igcn_fn(mh, device="cpu", backbone=backbone_plain)(
                prepare_weights(mh, "cpu"), bn_state(mh), ms_x.cpu(), t.cpu())
            s_out = max_err(out_p.cpu(), out_h)
            s_fp = max_err(aux_p["fixed_point"].cpu(), aux_h["fixed_point"])
            lim_fp = TOL_PIPELINE if seed == 0 else max(TOL_PIPELINE, s_fp)
            print(f"eval solve {solver} {k}/{k} B={IMPLICIT_BATCH} seed {seed}: max|fused-plain| out "
                  f"{e_out:.3e} fixed point {e_fp:.3e} (held to {lim_fp:.3e}; |fixed point| max "
                  f"{float(aux_p['fixed_point'].abs().max()):.3f})  iterations {aux['iterations']} / "
                  f"{aux_p['iterations']}; the plain twin on the card vs on the host: out "
                  f"{s_out:.3e} fixed point {s_fp:.3e}")
            check(e_out <= TOL_PIPELINE and e_fp <= lim_fp and bool(torch.isfinite(out).all()),
                  f"eval solve {solver} {k}/{k}, seed {seed}, against its plain twin")
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

    # 14 (margin). the damped step's first-step gradients on more seeds, one
    # draw each (its seed for the fused forward, that seed's Philox masks for
    # the module's), beside the module on the host: float32 rounding alone
    draw = make_draw(BETAS, dev, num_layers=model.num_layers, num_heads=model.num_heads,
                     hid_dim=model.hid_dim, dropout="prng", masks_dtype=torch.float32)
    host = torch.device("cpu")
    with torch.random.fork_rng(devices=[]):   # the later phases draw as before
        for s in MARGIN_SEEDS:
            torch.manual_seed(SEED + s)
            ms_model = with_solver(seeded_igcn(basis, dev, torch.Generator().manual_seed(SEED + s)),
                                   "damped", 20, 10).train()
            d = draw(batches[s % IMPLICIT_STEPS], torch.Generator(device=dev).manual_seed(SEED + s))
            gf, gm = implicit_grads(ms_model, d, "fused"), implicit_grads(ms_model, d, "module")
            d_host = d._replace(x_t=d.x_t.to(host), t=d.t.to(host), e=d.e.to(host),
                                masks=type(d.masks)(*(f.to(host) for f in d.masks)))
            gh = implicit_grads(copy.deepcopy(ms_model).to(host), d_host, "module")
            keys = [k for k in gf if not k.endswith("self_attn.linears.1.bias")]
            wf = max((grad_close(gf[k], gm[k]), k) for k in keys)
            wh = max((grad_close(gm[k].to(host), gh[k]), k) for k in keys)
            print(f"  damped 20/10, seed {SEED + s}: worst first-step gradient rel err fused vs module "
                  f"{wf[0]:.2e} ({wf[1]}); the module on the card vs on the host {wh[0]:.2e} ({wh[1]})")
            check(all(bool(torch.isfinite(v).all()) for v in (*gf.values(), *gm.values())),
                  f"damped 20/10, seed {SEED + s}: non-finite gradients")

    # 16 (kernel part). times
    times = {}
    with torch.no_grad():
        for bsz in ROW3_BATCHES[:2]:
            z, tp = inputs[bsz]
            ms = time_ms(lambda: _launch_backbone(w, z, tp))
            plain_ms = time_ms(lambda: backbone_plain(w, z, tp), reps=3)
            fl, by = backbone_flops(w, bsz), backbone_bytes(w, bsz)
            bms, bwhat, bms32 = backbone_bound(w, bsz)
            times[bsz] = (ms, plain_ms, bms, bwhat, bms32)
            print(f"backbone B={bsz}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bms:.4f} ms "
                  f"({bwhat}; {100 * bms / ms:.1f}%; {fl / 1e9:.2f} GFLOP, {by / 1e6:.1f} MB)  "
                  f"FP32-only bound {bms32:.4f} ms ({100 * bms32 / ms:.1f}%)  "
                  f"{fl / ms / 1e9:.1f} TFLOP/s  [{card}]")
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
    pair = train_pair_times(wt, z, tp, seed, g, None, card,
                            f"B={IMPLICIT_BATCH}, {wt['num_layers']} layers (implicit)")
    if "--profile" in sys.argv[1:]:
        profile_fused_step((state, step), d, steps=2)
    ms, plain_ms, bms, bwhat, bms32 = times[IMPLICIT_BATCH]
    record = dict(name="net_kernel[backbone]", route="cuda",
                  source="diffpose_tpu_torch/csrc/net_kernel.cu",
                  replaces="diffpose_tpu/ops/pallas_denoiser.py:276", max_abs_err=err, ms=ms,
                  plain_ms=plain_ms, bound_ms=bms, bound_by=bwhat, library_ms=None,
                  bound_ms_fp32=bms32, batch=IMPLICIT_BATCH, ms_b1024=times[ROW3_BATCHES[1]][0],
                  bound_ms_b1024=times[ROW3_BATCHES[1]][2],
                  bound_ms_fp32_b1024=times[ROW3_BATCHES[1]][4])
    return record, pair


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
            "bwd_prng": 2 * steps_per_epoch * per_step[1], "temporal": 0, "st": 0}
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


# ---------------------------------------------------------------------------
# The video family (phases 17-21)
# ---------------------------------------------------------------------------


def seeded_video(basis, dev, gen, frames: int, **kw):
    """A SpatioTemporalDiff at the config's widths with a seeded init, every
    term live (``randomize``), in eval mode."""
    model = SpatioTemporalDiff(basis, frames, **kw)
    randomize(model, gen)
    return model.to(dev).eval()


def temporal_flops(rows: int, frames: int, hid: int = 96, heads: int = 4):
    """Operations of one TemporalBlock launch as rows 9-10 compute it, as
    (tensor-core products, the rest): multiply-adds (×2) of QKV, the
    out-projection and the two feed-forward products per frame, and of the
    attention's scores and value sums over the window (``mma.sync``); the
    softmax at 5 operations a score, the two LayerNorms at 8 an element, the
    biases, ReLU and residual adds at 11 an element of a frame vector."""
    prod = 2 * rows * (frames * (3 * hid * hid + hid * hid + 4 * hid * hid)
                       + 2 * frames * frames * hid)
    rest = rows * (5 * heads * frames * frames + frames * hid * (2 * 8 + 11))
    return prod, rest


def temporal_bytes(rows: int, frames: int, hid: int = 96) -> int:
    """The block's weights, its input read once and its output written once."""
    weights = 4 * (3 * hid * hid + 3 * hid + hid * hid + 5 * hid + 4 * hid * hid + 3 * hid)
    return weights + 2 * 4 * rows * frames * hid


def temporal_bound(rows: int, frames: int, tier: str = "bf16x3"):
    """Row 10's bound, ``tf32_bounds``' ``(ms, by, fp32_ms)``, and its operations."""
    flops = temporal_flops(rows, frames)
    return tf32_bounds(flops, temporal_bytes(rows, frames), tier), sum(flops)


def st_bound(w, windows: int, frames: int, tier: str = "bf16x3"):
    """Row 9's bound, ``tf32_bounds``' ``(ms, by, fp32_ms)``: row 3's layer at
    B·F frames plus row 10 at B·17 rows, each split as theirs; and its
    operations and bytes."""
    prod, rest = stack_flops(w, windows * frames)
    tprod, trest = temporal_flops(windows * 17, frames)
    by = backbone_bytes(w, windows * frames) + temporal_bytes(windows * 17, frames)
    return tf32_bounds((prod + tprod, rest + trest), by, tier), prod + tprod + rest + trest, by


def video_work(windows: int, frames: int):
    """Rows 9-10's work items at a shape: the CTA tiles of 68 frame vectors
    of T1 and T3 (row 9's spatial phase: tiles of 4 frames, as many), the
    warp tasks of T2 (16 queries of one (window, joint) row and head)."""
    return -(-windows * frames * 17 // 68), windows * 17 * 4 * -(-frames // 16)


def video_windows(n: int, frames: int, seed: int) -> dict:
    data = synthetic_video_dataset(n, frames, seed=seed)
    return {"poses_3d": data.poses_3d, "poses_2d_gmm": data.poses_2d_gmm,
            "seeds": np.arange(n, dtype=np.int32) * 7919 - 5}


def video_kernel_phases(dev, basis, gen, g, card):
    """Phases 17-19 and the kernel times of 21; returns the records of rows 9
    and 10 without their main-path launches, the launches of the
    explicit-mask train pair in phase 19, and row 3's time at the video
    shape."""
    from diffpose_tpu_torch.ops import fused_video_full as fv
    from diffpose_tpu_torch.ops import fused_video_train as fvt
    from diffpose_tpu_torch.ops.fused_video import make_video_denoiser_fn
    from diffpose_tpu_torch.train.video_steps import make_video_eval_step, make_video_train_step

    # 17. rows 9 and 10 against their plain versions at every shape
    kept, errs = {}, {"row9": 0.0, "row10": 0.0}
    with torch.no_grad():
        for frames, windows in VIDEO_SHAPES:
            m = seeded_video(basis, dev, gen, frames)
            vw = fv.prepare_video_weights(m, dev)
            lw, tw = vw["layers"], vw["temporal"]
            x = torch.randn((windows, frames, 17, 5), generator=g, device=dev)
            t = torch.randint(0, len(BETAS), (windows,), generator=g, device=dev).float()
            h = fv.embed(vw, x)
            tp = fv.spatial_projections(vw["spatial"], t, frames)[1]
            ht = fv.to_rows(h).contiguous()
            o10 = fv._launch_temporal(tw, ht, 1)
            o9 = fv._launch_st(lw, tw, h, tp, 1)
            torch.cuda.synchronize()
            e10 = max_err(o10, fv.temporal_layer_plain(tw, ht, 1))
            e9 = max_err(o9, fv.st_layer_plain(lw, tw, h, tp, 1))
            print(f"video F={frames} windows={windows}: row 10 max|kernel-plain| {e10:.3e}  row 9 "
                  f"{e9:.3e}  |out| max {float(o9.abs().max()):.3f}")
            check(e10 <= TOL_KERNEL and e9 <= TOL_KERNEL and bool(torch.isfinite(o9).all()),
                  f"rows 9/10 at F={frames}, {windows} windows")
            errs = {"row9": max(errs["row9"], e9), "row10": max(errs["row10"], e10)}
            kept[(frames, windows)] = (vw, h, tp, ht)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    occupancy = {k: fv.kernel_occupancy(dev, k) for k in ("temporal", "st")}
    phases = {}
    for name, row in (("temporal", 10), ("st", 9)):
        occ = occupancy[name]
        ctas = occ["ctas_per_sm"] * sms
        warps = ctas * occ["threads"] // 32
        print(f"row {row} occupancy: {occ['ctas_per_sm']} CTA an SM x {sms} SMs, "
              f"{occ['threads']} threads a CTA, {occ['regs']} registers a thread, "
              f"{occ['smem_bytes']} bytes of shared memory")
        for frames, windows in VIDEO_SHAPES:
            tiles, tasks = video_work(windows, frames)
            print(f"  row {row} F={frames} windows={windows}: "
                  f"{'S and ' if row == 9 else ''}T1, T3: {tiles} tiles, "
                  f"{tiles / ctas:.2f} waves of {ctas} CTAs; T2: {tasks} warp tasks, "
                  f"{tasks / warps:.2f} waves of {warps} warps")
            if (frames, windows) == (VIDEO_FRAMES, VIDEO_BATCH):
                check(tiles >= ctas and tasks >= warps,
                      f"row {row} at {windows}x{frames}: a phase has fewer work items than "
                      f"co-resident CTAs (warps in T2)")
            vw, h, tp, ht = kept[(frames, windows)]
            launch = ((lambda: fv._launch_temporal(vw["temporal"], ht, 1)) if row == 10 else
                      (lambda: fv._launch_st(vw["layers"], vw["temporal"], h, tp, 1)))
            cyc = video_phases.cycles(launch)
            total = cyc.pop("total")
            phases[(row, frames, windows)] = dict(cyc, total=total)
            print(f"    block 0's cycles, {total} in all: " + ", ".join(
                f"{k} {v} ({100 * v / total:.1f}%)" for k, v in cyc.items()
                if row == 9 or k != "S"))

    # 18. the three eval forwards and the eval step with each, at B=16
    frames, windows = VIDEO_FRAMES, VIDEO_BATCH
    model = seeded_video(basis, dev, gen, frames)
    vw = fv.prepare_video_weights(model, dev)
    x = torch.randn((windows, frames, 17, 5), generator=g, device=dev)
    t = torch.full((windows,), float(SEQ[-1]), device=dev)
    fns = {"fused": make_video_denoiser_fn(model),
           "fused_st": make_video_denoiser_fn(model, temporal_impl="kernel"),
           "fused_full": fv.make_video_full_fn(model)}
    per_call = {"fused": {"backbone": 4}, "fused_st": {"backbone": 4, "temporal": 4},
                "fused_full": {"st": 4}}
    with torch.no_grad():
        ref = model(x, t)
        for name, fn in fns.items():
            reset_launch_counts()
            out = fn(vw, x, t)
            torch.cuda.synchronize()
            got = {k: v for k, v in launch_counts().items() if v}
            e = max_err(out, ref)
            print(f"video denoiser {name} B={windows}: max|fn-module| {e:.3e}  launches {got}")
            check(e <= TOL_PIPELINE and got == per_call[name], f"video denoiser {name}: {e}, {got}")
        batch = video_windows(windows, frames, seed=SEED + 4)
        state = TrainState.create(model, None)
        steps = {impl: make_video_eval_step(model, BETAS, SEQ, device=dev, mask=torch.ones(1, 1, 17, device=dev),
                                            denoise_override=fn)
                 for impl, fn in (("module", None), *fns.items())}
        res = {impl: st(state, batch, prepared=st.prepare(state)) for impl, st in steps.items()}
        for impl in fns:
            e = max(max_err(a, b) for a, b in zip(res[impl], res["module"]))
            print(f"video eval step {impl}: max|step-module step| {e:.3e} (p1, p2, pred)  mean P1 "
                  f"{1e3 * float(res[impl][0].mean()):.4f} mm")
            check(e <= TOL_PIPELINE, f"video eval step {impl}")

    # 19. the fused train step against the module forward (rates 0, entry by
    # entry) and against the plain step over the same draws (3 steps)
    quiet = copy.deepcopy(model).train()
    quiet.dropout_rate = 0.0
    for mod in quiet.modules():
        if isinstance(mod, torch.nn.Dropout):
            mod.p = 0.0
    e = torch.randn(x.shape, generator=g, device=dev)
    ones = make_dropout_masks(g, num_layers=4, n_pts=17, batch=windows * frames, num_heads=4,
                              hid_dim=96, dtype=torch.uint8, rates=(0.0, 0.0, 0.0))
    params = list(quiet.parameters())
    out_f = fvt.make_video_train_fn(quiet, rates=(0.0, 0.0, 0.0))(x, t, ones, None)
    g_f = torch.autograd.grad(((e - out_f) ** 2).sum(dim=(1, 2, 3)).mean(), params)
    out_m = quiet(x, t)
    g_m = torch.autograd.grad(((e - out_m) ** 2).sum(dim=(1, 2, 3)).mean(), params)
    # The key projections' biases have a gradient of 0 (softmax ignores a
    # shift of every score of a row): both give rounding noise there.
    names = [n for n, _ in quiet.named_parameters()]
    zero = [i for i, n in enumerate(names) if n.endswith(("attn.k.bias", "self_attn.linears.1.bias"))]
    top = max(float(v.abs().max()) for v in g_m)
    noise = max(float(gg[i].abs().max()) for gg in (g_f, g_m) for i in zero) / top
    worst = max((grad_close(g_f[i], g_m[i]), names[i]) for i in range(len(names)) if i not in zero)
    e_out = max_err(out_f, out_m)
    print(f"video train fn rates 0 vs the module: max|out| {e_out:.3e}  worst grad rel "
          f"{worst[0]:.1e} ({worst[1]}); the key biases' (0 in exact arithmetic) up to {noise:.1e} "
          f"of the largest entry")
    check(e_out <= TOL_KERNEL and worst[0] < GRAD_REL and noise < GRAD_REL, "video train fn at rates 0")
    del out_f, out_m, g_f, g_m

    train_batches = [video_windows(windows, frames, seed=SEED + 5 + i) for i in range(VIDEO_STEPS)]
    masks_launches, ctx = {}, {}
    for dropout in ("masks", "prng"):
        runs = {}
        for impl in ("fused", "plain"):
            mm = copy.deepcopy(model).train()
            opt = make_optimizer(mm.parameters(), lr=TRAIN_LR)
            st = TrainState.create(mm, opt, ema_register(mm))
            step = make_video_train_step(mm, opt, BETAS, impl=impl, device=dev, dropout=dropout)
            gd = torch.Generator(device=dev).manual_seed(SEED + 6)
            draws = [step.draw(b, gd) for b in train_batches]
            reset_launch_counts()
            losses = [float(step.apply(st, d)[1]["loss"]) for d in draws]
            counts = launch_counts()
            runs[impl] = losses
            if impl == "fused":
                keys = ("fwd", "bwd") if dropout == "masks" else ("fwd_prng", "bwd_prng")
                check(tuple(counts[k] for k in keys) == (4 * VIDEO_STEPS, 4 * VIDEO_STEPS),
                      f"video {dropout} step launches {counts}")
                if dropout == "masks":
                    masks_launches = {k: counts[k] for k in keys}
                else:
                    ctx = dict(state=st, step=step, draws=draws[0])
        rel = [abs(a - b) / abs(b) for a, b in zip(runs["fused"], runs["plain"])]
        print(f"video train step {dropout} fused vs plain, {VIDEO_STEPS} steps: losses "
              f"{[round(v, 4) for v in runs['fused']]}  rel diff " + " ".join(f"{v:.2e}" for v in rel))
        check(max(rel) <= TOL_STEP_LOSS and all(v == v for v in runs["fused"]),
              f"video {dropout} step: fused against plain")

    # 21 (kernel part). times, turn by turn where two versions are compared
    records = {}
    with torch.no_grad():
        for (frames_k, windows_k), (vw_k, h, tp, ht) in kept.items():
            lw, tw = vw_k["layers"], vw_k["temporal"]
            rows = windows_k * 17
            k10 = time_ms(lambda: fv._launch_temporal(tw, ht, 1))
            p10 = time_ms(lambda: fv.temporal_layer_plain(tw, ht, 1), reps=3)
            (b10, by10, b10_32), fl10 = temporal_bound(rows, frames_k)
            y = _layer_norm(ht, tw["tln1s"][1], tw["tln1b"][1])
            q, k, v = (y @ tw["twqkv"][1] + tw["tbqkv"][1]).split(96, dim=-1)
            q, k, v = (z.reshape(rows, frames_k, 4, 24).transpose(1, 2).contiguous() for z in (q, k, v))
            sdpa = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(q, k, v, scale=1.0))
            lib_block = time_ms(lambda: library_temporal_block(tw, ht, 1), reps=3)
            k9 = time_ms(lambda: fv._launch_st(lw, tw, h, tp, 1))
            p9 = time_ms(lambda: fv.st_layer_plain(lw, tw, h, tp, 1), reps=3)
            (b9, by9, b9_32), fl9, _ = st_bound(lw[1], windows_k, frames_k)
            print(f"row 10 F={frames_k} rows={rows}: kernel {k10:.4f} ms  plain {p10:.4f} ms  bound "
                  f"{b10:.4f} ms ({by10}; {fl10 / 1e9:.3f} GFLOP; products and attention at TF32; "
                  f"{100 * b10 / k10:.1f}%)  FP32-only bound {b10_32:.4f} ms "
                  f"({100 * b10_32 / k10:.1f}%)  {fl10 / k10 / 1e9:.2f} TFLOP/s  "
                  f"library: SDPA on its q/k/v {sdpa:.4f} ms, the block from library calls "
                  f"{lib_block:.4f} ms  [{card}]")
            print(f"row 9 F={frames_k} windows={windows_k}: kernel {k9:.4f} ms  plain {p9:.4f} ms  bound "
                  f"{b9:.4f} ms ({by9}; {fl9 / 1e9:.3f} GFLOP; every product at TF32; "
                  f"{100 * b9 / k9:.1f}%)  FP32-only bound {b9_32:.4f} ms ({100 * b9_32 / k9:.1f}%)  "
                  f"{fl9 / k9 / 1e9:.2f} TFLOP/s  [{card}]")
            records[(frames_k, windows_k)] = dict(k10=k10, p10=p10, b10=b10, by10=by10,
                                                  b10_32=b10_32, sdpa=sdpa, lib_block=lib_block,
                                                  k9=k9, p9=p9, b9=b9, by9=by9, b9_32=b9_32)
            if (frames_k, windows_k) == (VIDEO_FRAMES, VIDEO_BATCH):
                z = h.reshape(-1, 17, 96)
                k3 = time_ms(lambda: _launch_backbone(lw[1], z, tp))
                b3, _, b3_32 = backbone_bound(lw[1], z.shape[0])
                print(f"row 3 at B·F={z.shape[0]} frames (one video spatial block): {k3:.4f} ms  "
                      f"bound {b3:.4f} ms ({100 * b3 / k3:.1f}%)  FP32-only bound {b3_32:.4f} ms "
                      f"({100 * b3_32 / k3:.1f}%)  [{card}]")
                row3_video = dict(ms_video=k3, bound_ms_video=b3, bound_ms_fp32_video=b3_32,
                                  video_rows=z.shape[0])
        for name, fn in fns.items():
            ms = time_ms(lambda: fn(vw, x, t), reps=5)
            print(f"video denoiser {name} B={windows}: {ms:.4f} ms a call  [{card}]")
        mod_ms = time_ms(lambda: model(x, t), reps=3)
        print(f"video denoiser module B={windows}: {mod_ms:.4f} ms a call  [{card}]")
        for impl, st_fn in steps.items():
            prepared = st_fn.prepare(state)
            ms = time_ms(lambda: st_fn(state, batch, prepared=prepared), reps=2, runs=5)
            print(f"video eval step {impl} B={windows}: {ms:.4f} ms, "
                  f"{windows * frames / ms * 1e3:.1f} frames/s  [{card}]")

    # the fused train step (prng) by parts
    st, step, d = ctx["state"], ctx["step"], ctx["draws"]
    step_ms = time_ms(lambda: step.apply(st, d), reps=2, runs=5)
    w1 = fv.layer_weights(prepare_weights(fv.SpatialBlocks(st.model), dev))[0]
    (vw0, h0, tp0, _) = kept[(VIDEO_FRAMES, VIDEO_BATCH)]
    z = h0.reshape(-1, 17, 96)
    seed = d.seed
    ikeep = ft._inv_keep(fvt.video_dropout_rates(st.model))
    drop = ft._seeded(seed, fvt.video_dropout_rates(st.model))
    stf = ft._launch_fwd(w1, z, tp0, drop, ikeep)[1]
    dd5 = torch.randn_like(z)
    ds = ft._launch_bwd(w1, drop, stf, dd5, ikeep)[2]
    fwd_ms = time_ms(lambda: ft._launch_fwd(w1, z, tp0, drop, ikeep))
    bwd_ms = time_ms(lambda: ft._launch_bwd(w1, drop, stf, dd5, ikeep))
    wg_ms = time_ms(lambda: ft.weight_grads(w1, stf, ds))
    rest = step_ms - 4 * (fwd_ms + bwd_ms + wg_ms)
    print(f"video train step B={windows}x{frames} (prng, draws given): {step_ms:.4f} ms, "
          f"{windows * frames / step_ms * 1e3:.1f} frames/s; parts: 4 seeded forward kernels "
          f"{4 * fwd_ms:.4f} ({fwd_ms:.4f} each), 4 backward {4 * bwd_ms:.4f} ({bwd_ms:.4f}), 4 "
          f"weight_grads {4 * wg_ms:.4f} ({wg_ms:.4f}), rest (temporal blocks under autograd, "
          f"ChebConvs, weight prep, clip, Adam, EMA) {rest:.4f} ms  [{card}]")
    pair = train_pair_times(w1, z, tp0, seed, g, fvt.video_dropout_rates(st.model), card,
                            f"{z.shape[0]} rows, 1 layer (video)")

    r = records[(VIDEO_FRAMES, VIDEO_BATCH)]
    extra = {f"F{f}_B{b}": {k: v for k, v in rec.items()
                            if k in ("k10", "k9", "b10", "b10_32", "b9", "b9_32", "p10", "p9",
                                     "sdpa", "lib_block")}
             for (f, b), rec in records.items() if (f, b) != (VIDEO_FRAMES, VIDEO_BATCH)}
    common = dict(route="cuda", source="diffpose_tpu_torch/csrc/video_kernel.cu", batch=VIDEO_BATCH,
                  frames=VIDEO_FRAMES)
    row10 = dict(name="video_kernel[temporal]", replaces="diffpose_tpu/ops/pallas_video_full.py:329",
                 max_abs_err=errs["row10"], ms=r["k10"], plain_ms=r["p10"], bound_ms=r["b10"],
                 bound_by=r["by10"], bound_ms_fp32=r["b10_32"], library_ms=r["sdpa"],
                 library_what="scaled_dot_product_attention on the block's q/k/v [272, 4, 81, 24]",
                 library_block_ms=r["lib_block"], other_shapes=extra,
                 occupancy=occupancy["temporal"],
                 cycles={f"F{f}_B{b}": c for (row, f, b), c in phases.items() if row == 10},
                 **common)
    row9 = dict(name="video_kernel[st_layer]", replaces="diffpose_tpu/ops/pallas_video_full.py:148",
                max_abs_err=errs["row9"], ms=r["k9"], plain_ms=r["p9"], bound_ms=r["b9"],
                bound_by=r["by9"], bound_ms_fp32=r["b9_32"], library_ms=None,
                occupancy=occupancy["st"],
                cycles={f"F{f}_B{b}": c for (row, f, b), c in phases.items() if row == 9},
                **common)
    return row9, row10, masks_launches, row3_video, pair


def library_temporal_block(tw, ht, layer):
    """The TemporalBlock from library calls (``F.linear`` products,
    ``scaled_dot_product_attention``, the Bessel LayerNorm by hand): a
    yardstick for row 10, used nowhere in the port."""
    fn = torch.nn.functional
    n, f, hid = ht.shape
    y = _layer_norm(ht, tw["tln1s"][layer], tw["tln1b"][layer])
    qkv = fn.linear(y, tw["twqkv"][layer].t(), tw["tbqkv"][layer])
    q, k, v = (z.reshape(n, f, 4, -1).transpose(1, 2) for z in qkv.split(hid, dim=-1))
    att = fn.scaled_dot_product_attention(q, k, v, scale=1.0).transpose(1, 2).reshape(n, f, hid)
    x = ht + fn.linear(att, tw["twao"][layer].t(), tw["tbao"][layer])
    y = fn.relu(fn.linear(_layer_norm(x, tw["tln2s"][layer], tw["tln2b"][layer]),
                          tw["tff1"][layer].t(), tw["tbff1"][layer]))
    return x + fn.linear(y, tw["tff2"][layer].t(), tw["tbff2"][layer])


def video_cli_phases(card):
    """Phases 20-21: ``cli.main_video`` in process at the config's widths:
    train 2 epochs, resume for a third, evaluate the checkpoint with each
    fused eval forward; then the video runner's times.  Returns the launch
    counts of the training run."""
    from diffpose_tpu_torch.cli import main_video
    from diffpose_tpu_torch.cli.common import setup_experiment
    from diffpose_tpu_torch.train.video_runner import VideoRunner

    exp = Path(tempfile.mkdtemp(prefix="chip_smoke_video_"))
    b, layers = VIDEO_BATCH, 4
    steps_per_epoch = -(-VIDEO_WINDOWS // b)
    eval_batches = -(-(VIDEO_WINDOWS // 4) // b)
    per_batch = len(SEQ) * layers           # launches of one kernel an eval batch
    common = ["--config", VIDEO_CONFIG, "--exp", str(exp), "--ni", "--synthetic_windows",
              str(VIDEO_WINDOWS)]
    train = common + ["--doc", "run", "--train", "--train_impl", "fused", "--dropout_impl", "prng",
                      "--denoiser_impl", "fused"]
    run = exp / "run"

    # 20. train, resume, eval-only with each fused forward
    reset_launch_counts()
    check(main_video.main(train + ["--n_epochs", "2"]) == 0, "the video CLI training run failed")
    torch.cuda.synchronize()
    counts = launch_counts()
    zero = {k: 0 for k in counts}
    want = dict(zero, backbone=2 * eval_batches * per_batch,
                fwd_prng=2 * steps_per_epoch * layers, bwd_prng=2 * steps_per_epoch * layers)
    print(f"main path (video CLI: 2 epochs of {steps_per_epoch} steps, {eval_batches} eval batches "
          f"each) launches: {counts}")
    check(counts == want, f"video CLI training run launches {counts}, expected {want}")
    check(main_video.main(train + ["--n_epochs", "3", "--resume"]) == 0, "the video CLI resume failed")
    log = (run / "stdout.txt").read_text()
    check(f"resumed from step {2 * steps_per_epoch} (epoch 2)" in log, "the video resume was not logged")
    check(log.count("| Epoch 00") == 3, "the resumed video run did not train exactly one more epoch")
    losses = [float(v) for v in re.findall(r"\| loss ([0-9.eE+-]+|nan|inf) \|", log)]
    print(f"video CLI epoch losses {losses}")
    check(len(losses) == 3 and all(v == v and abs(v) != float("inf") for v in losses),
          f"video epoch losses {losses}")
    last = 3 * steps_per_epoch
    files = sorted(f.name for f in run.iterdir())
    for name in ("config.yml", "stdout.txt", f"ckpt_{last:08d}.pth"):
        check(name in files, f"{name} missing from the video run's folder: {files}")
    trained = logged_errors(run / "stdout.txt")[-1]
    alone, runs = {}, {"train": counts}
    for impl, kernel in (("fused", "backbone"), ("fused_st", None), ("fused_full", "st")):
        reset_launch_counts()
        check(main_video.main(common + ["--doc", f"eval_{impl}", "--track_metrics", "--denoiser_impl",
                                        impl, "--model_diff_path", str(run / f"ckpt_{last:08d}.pth")])
              == 0, f"the video CLI eval run ({impl}) failed")
        got = launch_counts()
        n = eval_batches * per_batch
        exp_counts = (dict(zero, backbone=n, temporal=n) if impl == "fused_st"
                      else dict(zero, **{kernel: n}))
        check(got == exp_counts, f"video CLI eval-only {impl} launches {got}, expected {exp_counts}")
        alone[impl] = logged_errors(exp / f"eval_{impl}" / "stdout.txt")[-1]
        runs[impl] = got
    print(f"video eval-only from the checkpoint, P1/P2 mm: {alone}; the training run's last epoch "
          f"{trained}")
    check(all(max(abs(a - c) for a, c in zip(trained, v)) <= 1e-3 for v in alone.values()),
          "video eval-only P1/P2 disagree with each other or with the training run's last eval")

    # 21 (runner part). train epochs and throughput_stats() per fused forward
    args = main_video.parse_args(train + ["--doc", "times", "--n_epochs", "3"])
    config = setup_experiment(args)
    runner = VideoRunner(config, seed=args.seed, log_dir=None, denoiser_impl="fused",
                         train_impl="fused", dropout_impl="prng")
    runner.create_video_model()
    runner.set_data(synthetic_video_dataset(VIDEO_WINDOWS, config.video.frames, seed=args.seed),
                    synthetic_video_dataset(VIDEO_WINDOWS // 4, config.video.frames, seed=args.seed + 1))
    runner.train()
    secs = runner.train_seconds
    frames_epoch = VIDEO_WINDOWS * config.video.frames
    print(f"video runner train epochs of {VIDEO_WINDOWS} windows ({frames_epoch} frames) at B={b} "
          f"(fused, prng): " + " ".join(f"{v:.4f}" for v in secs)
          + f" s; last epoch {frames_epoch / secs[-1]:.1f} frames/s  [{card}]")
    for impl in ("fused", "fused_st", "fused_full", "fused"):
        runner.denoiser_impl = impl
        runner._eval_cache.clear()
        runner.evaluate(is_train=True)
        print(f"video runner eval {impl} (seconds a batch "
              f"{[round(v, 4) for v in runner.inference_times]}): {runner.throughput_stats()}  [{card}]")
    logging.getLogger().handlers.clear()
    shutil.rmtree(exp)
    return runs


# ---------------------------------------------------------------------------
# The standalone GraFormer and row 4 (phase 22); the probes, rows 11-12 (23-24)
# ---------------------------------------------------------------------------


def cheb_bound(bsz: int, n: int, c: int, d: int, k1: int, nnz: int, wide: bool):
    """Row 4's least times, ``(ms, by, fp32_ms)``: the channel product and the
    sparse joint mix and bias, x and w read once, y written once.  The wide
    path (``wide``) counts its channel product at the TF32 tensor-core peak,
    three passes, and the mix and bias at the FP32 peak (``tf32_bounds``);
    the narrow paths, all on the CUDA cores, every operation at the FP32
    peak, as ``fp32_ms`` counts it for both."""
    prod, rest = 2 * bsz * n * k1 * c * d, 2 * bsz * nnz * c + bsz * n * d
    nbytes = 4 * (bsz * n * (c + d) + k1 * c * d + d) + 8 * nnz + 4 * (n + 1)
    if wide:
        return tf32_bounds((prod, rest), nbytes)
    ms, by = bound_of(prod + rest, nbytes)
    return ms, by, ms


def cheb_shape(name, x, w, b, gconst, card, timed=True):
    """Row 4 against ``cheb_conv_plain`` on one shape (bound 5e-5), the wide
    path also against its TF32 model on a few samples, and its ms (wrapper
    calls), device ms, the plain version's and ``torch.einsum``'s ms beside
    both bounds."""
    bsz, n, c = x.shape
    k1, _, d = w.shape
    plan = fc.kernel_plan(x.device, bsz, n, c, d, k1)
    with torch.no_grad():
        got = fc.fused_cheb_conv(x, w, b, gconst)
        torch.cuda.synchronize()
        err = max_err(got, fc.cheb_conv_plain(x, w, b, gconst["basis"]))
        model_err = None
        if plan["kernel"] == "wide":
            few = slice(0, CHEB_MODEL_SAMPLES)
            model = fc.cheb_conv_plain(x[few].cpu(), w.cpu(), b.cpu(), gconst["basis"].cpu(),
                                       matmul=matmul_3xtf32)
            model_err = max_err(got[few].cpu(), model)
    print(f"row 4 {name:>9s} {c:3d}->{d:3d} N={n} B={bsz:5d} ({plan['kernel']}, {plan['tb']} samples "
          f"a CTA, {plan['ctas']} x {plan['chunks']} CTAs): max|kernel-plain| {err:.3e}"
          + ("" if model_err is None else f"  max|kernel-TF32 model| {model_err:.3e}"))
    check(err <= TOL_KERNEL, f"row 4 {name} {c}->{d} N={n} B={bsz}: {err}")
    rec = dict(c_in=c, d_out=d, n_pts=n, batch=bsz, max_abs_err=err, plan=plan,
               max_abs_err_tf32_model=model_err)
    if not timed:
        return rec
    basis = gconst["basis"]
    with torch.no_grad():
        rec["ms"] = time_ms(lambda: fc._launch(x, w, b, gconst))
        rec["device_ms"] = device_ms(lambda: fc._launch(x, w, b, gconst), "cheb_kernel")
        rec["device_clock"] = device_clock()
        rec["plain_ms"] = time_ms(lambda: fc.cheb_conv_plain(x, w, b, basis))
        rec["library_ms"] = time_ms(lambda: torch.einsum("knm,bmc,kcd->bnd", basis, x, w) + b)
    rec["bound_ms"], rec["bound_by"], rec["bound_ms_fp32"] = cheb_bound(
        bsz, n, c, d, k1, gconst["cheb_nnz"], plan["kernel"] == "wide")
    print(f"row 4 {name:>9s} {c:3d}->{d:3d} N={n} B={bsz:5d}: kernel {rec['ms']:.4f} ms (device "
          f"{rec['device_ms']:.4f} by {rec['device_clock']})  plain {rec['plain_ms']:.4f} ms  "
          f"einsum {rec['library_ms']:.4f} ms  bound {rec['bound_ms']:.4f} ms ({rec['bound_by']}, "
          f"{100 * rec['bound_ms'] / rec['device_ms']:.1f}% of the device time)  FP32-only bound "
          f"{rec['bound_ms_fp32']:.4f} ms ({100 * rec['bound_ms_fp32'] / rec['device_ms']:.1f}%)  "
          f"[{card}]")
    return rec


def chebconv_device_ms(fn, model, x, per_call: int, reps: int = 5):
    """Device time a forward, from ``torch.profiler`` (``probes.profiled``)
    over ``reps`` calls: of row 4's kernels inside the fused forward
    ``fn(x)``, and of the kernels that the module's ChebGraphConvs launch
    inside ``model(x)`` (each ChebGraphConv's call is a ``record_function``
    range, set by hooks).  Both are None where the profiler is not trusted
    in this process: CUDA events cannot split a forward by kernel."""
    from torch.profiler import record_function

    def run(f):
        def calls():
            for _ in range(reps):
                f(x)
        return calls

    try:
        with torch.no_grad():
            row4 = profiled(run(fn), lambda e: e.device_type.name == "CUDA" and "cheb_kernel" in e.name,
                            per_call * reps)
    except ProfilerBlind:
        return None, None
    fused_ms = sum(e.device_time_total for e in row4) / 1e3 / reps

    ranges, hooks = [], []

    def enter(*_):
        ranges.append(record_function("ChebGraphConv"))
        ranges[-1].__enter__()

    def leave(*_):
        ranges.pop().__exit__(None, None, None)

    for m in model.modules():
        if isinstance(m, ChebGraphConv):
            hooks += [m.register_forward_pre_hook(enter), m.register_forward_hook(leave)]
    try:
        with torch.no_grad():
            convs = profiled(run(model), lambda e: e.device_type.name == "CPU" and e.name == "ChebGraphConv",
                             per_call * reps, cpu=True)
    except ProfilerBlind:
        return None, None
    finally:
        for h in hooks:
            h.remove()
    module_ms = sum(e.device_time_total for e in convs) / 1e3 / reps
    check(fused_ms > 0 and module_ms > 0, "the profiler recorded no device time")
    return fused_ms, module_ms


def graformer_phases(dev, gen, g, card):
    """Phase 22: the standalone GraFormer's eval forward with its ChebConvs on
    row 4 (``make_graformer_fn``) against the module at full width, counted;
    row 4 against its plain version at GraFormer's three shapes at 21 joints
    (B=1024) and 17 joints (B=1000, ragged), and at the video family's I/O
    shapes; times.  Returns row 4's record."""
    basis21, basis17 = cheb_basis_from_edges(21, GAN_EDGES), cheb_basis_from_edges(17, H36M_EDGES)
    model = GraFormer(basis21)
    randomize(model, gen)
    model = model.to(dev).eval()
    fn = make_graformer_fn(model)
    bsz, per_call = GRAFORMER_BATCH, 2 + 2 * model.num_layers
    x = torch.randn((bsz, 21, 2), generator=g, device=dev)
    mask = torch.ones((bsz, 1, 21), device=dev)
    mask[:, :, [3, 19]] = 0.0

    # 22. the main path: one fused forward, counted
    with torch.no_grad():
        fc.fused_cheb_conv.launches = 0
        out = fn(x)
        torch.cuda.synchronize()
        launches = fc.fused_cheb_conv.launches
        e_fwd = max_err(out, model(x))
        e_mask = max_err(fn(x, mask), model(x, mask))
    print(f"main path (GraFormer eval forward, hid 128, 4 layers, 21 joints, B={bsz}) row-4 "
          f"launches: {launches}; max|fused-module| {e_fwd:.3e}, with two joints masked "
          f"{e_mask:.3e}")
    check(launches == per_call, f"GraFormer forward made {launches} row-4 launches, expected {per_call}")
    check(tuple(out.shape) == (bsz, 21, 3) and bool(torch.isfinite(out).all()),
          f"GraFormer output shape {tuple(out.shape)} or non-finite values")
    check(e_fwd <= TOL_PIPELINE and e_mask <= TOL_PIPELINE, f"GraFormer fused forward: {e_fwd}, {e_mask}")

    convs = {"input": model.gconv_input, "residual": model.gconv_layers[0].gconv1.gconv,
             "output": model.gconv_output}
    shapes = {}
    for n, basis, b in ((21, basis21, bsz), (17, basis17, GRAFORMER_RAGGED)):
        gconst = fc.graph_constants(basis, dev)
        for name, conv in convs.items():
            w, bias = conv.weight.detach()[:, 0], conv.bias.detach().reshape(-1)
            xin = torch.randn((b, n, w.shape[1]), generator=g, device=dev)
            shapes[(name, n)] = cheb_shape(name, xin, w, bias, gconst, card)
    gconst = fc.graph_constants(basis17, dev)
    for c, d in VIDEO_IO:
        conv = ChebGraphConv(c, d, basis17).to(dev)
        xin = torch.randn((VIDEO_BATCH * VIDEO_FRAMES, 17, c), generator=g, device=dev)
        shapes[(f"video{c}->{d}", 17)] = cheb_shape(
            "video", xin, conv.weight.detach()[:, 0], conv.bias.detach().reshape(-1), gconst, card)
    more = {}
    for n, b, c, d in CHEB_MORE:
        gc = fc.graph_constants(basis21 if n == 21 else basis17, dev)
        w = torch.randn((3, c, d), generator=g, device=dev) / (3 * c) ** 0.5
        more[f"{c}->{d}_N{n}_B{b}"] = cheb_shape(
            "wide", torch.randn((b, n, c), generator=g, device=dev), w,
            torch.randn((d,), generator=g, device=dev), gc, card, timed=False)
    usage, spills = ptxas_usage("cheb_kernel"), ptxas_usage("cheb_kernel", "spill")
    for entry, used in sorted(usage.items()):
        print(f"  ptxas cheb_kernel {entry}: {used}; {spills[entry]}")

    with torch.no_grad():
        module_ms = time_ms(lambda: model(x), reps=5)
        fused_ms = time_ms(lambda: fn(x), reps=5)
    launch_ms, module_conv_ms = chebconv_device_ms(fn, model, x, per_call)
    row4 = {k: shapes[(k, 21)] for k in convs}
    counts = {"input": 1, "residual": 2 * model.num_layers, "output": 1}
    launch_bound = sum(counts[k] * row4[k]["bound_ms"] for k in convs)
    launch_bound_fp32 = sum(counts[k] * row4[k]["bound_ms_fp32"] for k in convs)
    if launch_ms is None:
        launch_txt = conv_txt = "not measured (torch.profiler is not trusted in this process)"
    else:
        launch_txt, conv_txt = f"{launch_ms:.4f} ms", f"{module_conv_ms:.4f} ms"
    print(f"GraFormer forward B={bsz}: module {module_ms:.4f} ms, fused {fused_ms:.4f} ms "
          f"({bsz / fused_ms * 1e3:.1f} poses/s); device time a forward (torch.profiler): "
          f"its {per_call} row-4 launches {launch_txt} against a bound of "
          f"{launch_bound:.4f} ms (FP32-only {launch_bound_fp32:.4f}), the module's {per_call} "
          f"ChebGraphConvs {conv_txt}  [{card}]")
    mid = row4["residual"]
    others = {f"{k[0]}_N{k[1]}": {f: v[f] for f in ("c_in", "d_out", "batch", "ms", "device_ms",
                                                     "device_clock",
                                                     "plain_ms", "library_ms", "bound_ms",
                                                     "bound_by", "bound_ms_fp32", "plan",
                                                     "max_abs_err")}
              for k, v in shapes.items() if k != ("residual", 21)}
    every = [*shapes.values(), *more.values()]
    model_errs = [v["max_abs_err_tf32_model"] for v in every if v["max_abs_err_tf32_model"] is not None]
    return dict(name="cheb_kernel", route="cuda", source="diffpose_tpu_torch/csrc/cheb_kernel.cu",
                replaces="diffpose_tpu/ops/pallas_cheb.py:48", launches=launches,
                max_abs_err=max(v["max_abs_err"] for v in every), ms=mid["ms"],
                device_ms=mid["device_ms"], device_clock=mid["device_clock"],
                plain_ms=mid["plain_ms"], bound_ms=mid["bound_ms"],
                bound_by=mid["bound_by"], bound_ms_fp32=mid["bound_ms_fp32"],
                library_ms=mid["library_ms"], plan=mid["plan"],
                ptxas={k: f"{v}; {spills[k]}" for k, v in usage.items()},
                max_abs_err_tf32_model=max(model_errs), wide_checked_untimed=sorted(more),
                library_what="torch.einsum('knm,bmc,kcd->bnd', basis, x, w) + b",
                batch=bsz, n_pts=21, c_in=128, d_out=128, forward_launches_device_ms=launch_ms,
                module_chebconvs_device_ms=module_conv_ms,
                forward_bound_ms=launch_bound, forward_bound_ms_fp32=launch_bound_fp32,
                module_forward_ms=module_ms,
                fused_forward_ms=fused_ms, max_err_forward=max(e_fwd, e_mask), other_shapes=others,
                main_path=f"make_graformer_fn forward, B={bsz}")


def ptxas_usage(name: str, what: str = "registers") -> dict:
    """Each kernel entry's ``Used ... registers ...`` line (``what="spill"``:
    its ``... bytes spill stores, ... bytes spill loads`` line) from the build
    log of ``csrc/<name>.cu``."""
    usage, entry = {}, None
    for line in _build.build_log(name).splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        elif entry and what == "registers" and "Used" in line and "registers" in line:
            usage[entry] = line.split("Used", 1)[1].strip()
            entry = None
        elif entry and what == "spill" and "spill" in line:
            usage[entry] = line.split(":", 1)[-1].strip()
    return usage


# Rows 1-3's builds of net_forward_kernel (template arguments as mangled).
NET_ENTRIES = {"lifter": "ILb0ELb1ELi2ELi3E", "denoiser": "ILb1ELb1ELi5ELi5E",
               "backbone": "ILb1ELb0ELi96ELi96E"}


def check_no_spills(name: str, entries: int):
    """Every kernel entry of ``csrc/<name>.cu`` (``entries`` of them) spills
    nothing."""
    spills = ptxas_usage(name, "spill")
    check(len(spills) == entries and all(
        "0 bytes spill stores, 0 bytes spill loads" in v for v in spills.values()),
        f"{name}: a kernel spills registers: {spills}")


def net_ptxas(which: str) -> str:
    usage = ptxas_usage("net_kernel")
    return next(v for k, v in usage.items() if NET_ENTRIES[which] in k)


def ablate_phases(dev, wd, g, card):
    """Phase 23: row 11.  The probe's SKIP = 0 build is bit-equal to the
    production denoiser kernel (row 1); each variant is within 5e-5 of its
    plain twin; ms per variant at B=1024 and the share each part takes; the
    production builds' registers.  Returns row 11's record."""
    x = torch.randn((BATCH, 17, 5), generator=g, device=dev)
    t = torch.randint(0, len(BETAS), (BATCH,), generator=g, device=dev).to(torch.float32)
    with torch.no_grad():
        tp = timestep_projections(wd, t)
        prod = _launch(wd, x, tp)
        full = ablate.probe_forward(wd, x, tp)
        torch.cuda.synchronize()
        same = bool(torch.equal(full, prod))
        print(f"row 11: probe SKIP=0 build bit-equal to net_forward_kernel<true,true,5,5>: {same}")
        check(same, "the probe's SKIP = 0 build differs from the production kernel")
        errs = {}
        for name, parts in ablate.VARIANTS.items():
            got = ablate.probe_forward(wd, x, tp, parts)
            torch.cuda.synchronize()
            errs[name] = max_err(got, ablate.net_plain_ablated(wd, x, tp, parts))
        print("row 11 max|kernel-plain| by variant: " +
              "  ".join(f"{k} {v:.2e}" for k, v in errs.items()))
        check(max(errs.values()) <= TOL_KERNEL, f"row 11 variants against their plain twins: {errs}")
        ablate.probe_forward.launches = 0
        ms = ablate.run(inputs=(wd, x, tp))
        launches = ablate.probe_forward.launches
        check(launches > 0, "the probe's timed run launched no probe kernel")
        plain_ms = time_ms(lambda: ablate.net_plain_ablated(wd, x, tp, ()), reps=3)
    bms, by, bms32 = bound_ms(wd, BATCH)
    print(f"row 11 at B={BATCH} ({launches} launches), ms and the share of full left out  [{card}]:")
    for name in ablate.VARIANTS:
        print(f"  {name:11s} {ms[name]:.4f} ms  {100 * (1 - ms[name] / ms['full']):5.1f}%")
    for name, why in ablate.NOT_APPLICABLE.items():
        print(f"  {name:11s} not applicable: {why}")
    prod_usage, probe_usage = ptxas_usage("net_kernel"), ptxas_usage("probe_kernel")
    for entry, used in sorted(prod_usage.items()):
        print(f"  ptxas net_kernel {entry}: {used}")
    print(f"  dynamic shared memory of every net_forward_kernel build: "
          f"{ablate._library().probe_smem_bytes()} bytes")
    denoiser = [e for e in prod_usage if "net_forward_kernelILb1ELb1ELi5ELi5E" in e]
    check(len(denoiser) == 1 and probe_usage.get(denoiser[0]) == prod_usage[denoiser[0]],
          f"the probe's SKIP = 0 build uses other resources: {probe_usage} against {prod_usage}")
    return dict(name="probe_kernel[full]", route="cuda", source="diffpose_tpu_torch/csrc/probe_kernel.cu",
                replaces="scripts/probe_ablate.py:79", launches=launches,
                max_abs_err=max(errs.values()), ms=ms["full"], plain_ms=plain_ms, bound_ms=bms,
                bound_by=by, bound_ms_fp32=bms32, library_ms=None, batch=BATCH, variants_ms=ms,
                shares={k: 1 - v / ms["full"] for k, v in ms.items() if k != "full"},
                bit_equal_to_row1=same, main_path="probes/ablate.run (phase 23)")


def attention_bound(rows: int, frames: int, dk: int, passes: int = 3):
    """Row 12's least times in its 3xTF32 mode, ``(ms, by, fp32_ms)``: the two
    products on the tensor cores at the TF32 peak, ``passes`` times over;
    the softmax on the CUDA cores at the f32 peak; q, k and v read and the
    output written once.  ``fp32_ms``: every operation at the FP32 peak
    against the bytes."""
    prod, softmax = 4 * rows * frames * frames * dk, 5 * rows * frames * frames
    ops_ms = 1e3 * (passes * prod / PEAK_TF32 + softmax / PEAK_FP32)
    bytes_ms = 1e3 * 16 * rows * frames * dk / PEAK_BYTES
    ms, by = (ops_ms, "operations") if ops_ms >= bytes_ms else (bytes_ms, "bytes")
    return ms, by, max(1e3 * (prod + softmax) / PEAK_FP32, bytes_ms)


def attention_probe_phases(card):
    """Phase 24: row 12.  Both TF32 modes' max |Δ| against the f32 plain twin,
    ms (wrapper calls) and device ms at the JAX probe's shape and row 10's,
    beside SDPA and both bounds; 3xTF32 must be within 5e-5 at both; the
    grid and ptxas registers.  Then ``ops/tf32.py`` must equal ``mma.sync``
    bit for bit in every case of ``probes/tf32_gemm.py``.  Returns row 12's
    record."""
    batched_dot.batched_attention.launches = 0
    res = batched_dot.run()
    launches = batched_dot.batched_attention.launches
    check(launches > 0, "the attention probe's run launched no kernel")
    for shape, rec in res.items():
        bms, by, fp32 = attention_bound(*shape)
        rec["bound_ms"], rec["bound_by"], rec["bound_ms_fp32"] = bms, by, fp32
        three, one = rec["3xtf32"], rec["1xtf32"]
        print(f"row 12 T,F,dk={shape} ({three['ctas']} CTAs, {three['ctas_an_sm']} an SM): 3xTF32 "
              f"max|Δ| {three['max_abs_err']:.3e} {three['ms']:.4f} ms (device "
              f"{three['device_ms']:.4f}); 1xTF32 max|Δ| {one['max_abs_err']:.3e} {one['ms']:.4f} "
              f"ms (device {one['device_ms']:.4f}); plain {rec['plain_ms']:.4f} ms; SDPA "
              f"{rec['library_ms']:.4f} ms; bound {bms:.4f} ms ({by}, "
              f"{100 * bms / three['device_ms']:.1f}% of 3xTF32's device time), FP32-only bound "
              f"{fp32:.4f} ms  [{card}]")
        check(three["max_abs_err"] <= TOL_KERNEL, f"3xTF32 attention at {shape}: {three['max_abs_err']}")
    usage, spills = ptxas_usage("probe_attention"), ptxas_usage("probe_attention", "spill")
    for entry, used in sorted(usage.items()):
        print(f"  ptxas probe_attention {entry}: {used}; {spills[entry]}")
    tf32_gemm.gemm.launches = 0
    model_check = tf32_gemm.run()
    check(tf32_gemm.gemm.launches == len(model_check), "the TF32 probe launched no kernel")
    for name, rec in model_check.items():
        print(f"ops/tf32.py against mma.sync, {name}: {rec['differing']} of {rec['of']} elements "
              f"differ (max |Δ| {rec['max_abs_diff']:.3e})")
        check(rec["differing"] == 0, f"the plain TF32 model differs from mma.sync: {name}")
    first = res[batched_dot.SHAPES[0]]
    return dict(name="probe_attention[3xtf32]", route="cuda",
                source="diffpose_tpu_torch/csrc/probe_attention.cu",
                replaces="scripts/probe_batched_dot.py:22", launches=launches,
                max_abs_err=max(r["3xtf32"]["max_abs_err"] for r in res.values()),
                ms=first["3xtf32"]["ms"], device_ms=first["3xtf32"]["device_ms"],
                device_clock=first["3xtf32"]["device_clock"],
                plain_ms=first["plain_ms"], bound_ms=first["bound_ms"], bound_by=first["bound_by"],
                bound_ms_fp32=first["bound_ms_fp32"], library_ms=first["library_ms"],
                library_what="scaled_dot_product_attention(q, k, v, scale=1.0)",
                shape=list(batched_dot.SHAPES[0]),
                ptxas={k: f"{v}; {spills[k]}" for k, v in usage.items()},
                other={str(list(s)): r for s, r in res.items()},
                main_path="probes/batched_dot.run (phase 24)")


# ---------------------------------------------------------------------------
# Parallelism over torch.distributed (phases 25-27)
# ---------------------------------------------------------------------------

def parallel_spec(diff, pose, basis, gen) -> dict:
    """The sharded steps' inputs at full width for a world of 1 rank over
    nccl: the seeded GCNDiff and GCNPose, a seeded IGCN (damped 20/10, the
    well-conditioned train solve of phase 14), synthetic frames for
    PAR_STEPS steps of B=1024 (B=512 for the implicit step), one eval batch
    of B=1024; each step timed against the unsharded one."""
    igcn = with_solver(seeded_igcn(basis, "cpu", gen), *PAR_IMPLICIT_SOLVE)
    data = make_synthetic_dataset(num_frames=PAR_STEPS * BATCH, seed=SEED + 5)
    ev = make_synthetic_dataset(num_frames=BATCH, seed=SEED + 6)
    cpu = lambda m: {k: v.detach().cpu() for k, v in m.state_dict().items()}
    return dict(
        device="cuda", backend="nccl", cfg=dict(hid_dim=96, num_layers=5, num_heads=4),
        diff=cpu(diff), pose=cpu(pose), igcn=cpu(igcn),
        igcn_solver=dict(solver=igcn.solver, max_iterations=igcn.max_iterations,
                         min_iterations=igcn.min_iterations),
        batch=BATCH, steps=PAR_STEPS, lr=TRAIN_LR, eps=1e-8,
        seed=SEED + 7, data={"poses_3d": data.poses_3d, "poses_2d_gmm": data.poses_2d_gmm},
        train_impls=[("fused", "masks"), ("fused", "prng")], time=True, sweep=0,
        sweep_idx=np.random.default_rng(SEED).integers(0, len(data), (PAR_SWEEP, BATCH)),
        eval=dict(batch={"poses_3d": ev.poses_3d, "poses_2d_gmm": ev.poses_2d_gmm,
                         "seeds": np.arange(BATCH, dtype=np.int32) * 7919 - 5},
                  test_times=list(TEST_TIMES), hyp_test_times=[2], impl="fused",
                  iterations=PAR_IMPLICIT_EVAL_ITERS),
        implicit=dict(batch=IMPLICIT_BATCH, implicit_impls=["fused"], sweep=0,
                      eval=dict(batch={"poses_3d": ev.poses_3d[:IMPLICIT_BATCH],
                                       "poses_2d_gmm": ev.poses_2d_gmm[:IMPLICIT_BATCH],
                                       "seeds": np.arange(IMPLICIT_BATCH, dtype=np.int32)},
                                test_times=[1], iterations=PAR_IMPLICIT_EVAL_ITERS,
                                impl="fused")),
        implicit_dropout="prng")


def run_world(spec: dict, world: int, what: str,
              tasks=("frame", "implicit", "cli_frame", "cli_implicit")):
    """Spawn ``world`` ranks of ``parallel/worker.py`` over ``spec`` running
    ``tasks``; any rank's failure fails the run.  Returns the ranks' results
    and the seconds the world took."""
    out = Path(tempfile.mkdtemp(prefix="chip_smoke_world_"))
    torch.save(dict(spec, exp=str(out / "exp")), out / "spec.pth")
    argv = ["--spec", str(out / "spec.pth"), "--out", str(out)]
    for task in tasks:
        argv += ["--task", task]
    t0 = time.perf_counter()
    try:
        worker.spawn(world, argv, out / "logs", timeout=PAR_TIMEOUT)
    except RuntimeError as e:
        check(False, f"{what}: {e}")
    secs = time.perf_counter() - t0
    ranks = worker.load_ranks(out, world)
    shutil.rmtree(out)
    return ranks, secs


def held_steps(ranks, ref, tag: str, steps: int, exact: bool, implicit: bool = False,
               loss_rel: float = TOL_STEP_LOSS):
    """The ranks' train steps against the single-process reference: bit for
    bit (``exact``), else loss within TOL_STEP_LOSS and the gradient norm
    within TOL_STEP_GRAD_NORM relative, every gradient entry within
    GRAD_ABS / GRAD_REL, the parameters within TOL_PIPELINE (and the
    BatchNorm buffers within TOL_BN); the ranks' parameters equal.  Returns
    the worst errors, printed by the caller."""
    worst = {"loss": 0.0, "grad_norm": 0.0, "grad": 0.0, "params": 0.0, "bn": 0.0}
    keys = [k for k in ref if k.startswith(f"{tag}/")]
    for res in ranks:
        if exact:
            bad = [k for k in keys if not np.array_equal(res[k], ref[k])]
            check(not bad, f"{tag}: not bit-equal to the unsharded step: {bad[:4]}")
            continue
        for s in range(steps):
            for k in ("loss", "grad_norm"):
                a, b = float(res[f"{tag}/step{s}/{k}"]), float(ref[f"{tag}/step{s}/{k}"])
                worst[k] = max(worst[k], abs(a - b) / abs(b))
            for k in (k for k in keys if k.startswith(f"{tag}/step{s}/grad/")):
                worst["grad"] = max(worst["grad"], grad_close(torch.as_tensor(res[k]),
                                                              torch.as_tensor(ref[k])))
            if implicit:
                for k in ("running_mean", "running_var"):
                    key = f"{tag}/step{s}/{k}"
                    worst["bn"] = max(worst["bn"], float(np.abs(res[key] - ref[key]).max()))
        for k in (k for k in keys if k.startswith(f"{tag}/params/")):
            worst["params"] = max(worst["params"], float(np.abs(res[k] - ref[k]).max()))
    for k in (k for k in keys if k.startswith(f"{tag}/params/")):
        check(all(np.array_equal(r[k], ranks[0][k]) for r in ranks), f"{tag}: ranks' {k} differ")
    if not exact:
        check(worst["loss"] <= loss_rel and worst["grad_norm"] <= TOL_STEP_GRAD_NORM
              and worst["grad"] < GRAD_REL and worst["params"] <= TOL_PIPELINE
              and worst["bn"] <= TOL_BN, f"{tag} against the single-process step: {worst}")
    return worst


def held_eval(ranks, ref, tag: str, limits=(1e-6, 1e-5, 1e-6), data_ranks=None):
    """Per-sample P1/P2/pred of the data ranks (gathered in order): bit for
    bit the single-process eval of each rank's slice alone, and against the
    single-process eval of the whole batch within ``limits`` (P1, P2, pred;
    by default ``tests/test_parallel.py:99-101``'s).  Returns the errors
    against the whole batch."""
    errs = {}
    for key, tol in zip(("p1", "p2", "pred"), limits):
        got = worker.gathered(ranks, f"{tag}/{key}", data_ranks)
        check(np.array_equal(got, ref[f"{tag}/{key}_shards"]),
              f"{tag} {key}: not bit-equal to the single-process eval of each rank's slice")
        errs[key] = float(np.abs(got - ref[f"{tag}/{key}"]).max())
        check(errs[key] <= tol, f"{tag} {key}: max|Δ| {errs[key]:.3e} against the single-process "
              f"eval of the whole batch (limit {tol})")
    return errs


def pair_ms(res, tag: str) -> str:
    """The sharded and unsharded times of one step, by turns, and the
    sharded step's collectives alone (none where the worker ran on the host)."""
    if f"{tag}/ms_sharded" not in res:
        return "not timed"
    text = (f"{', '.join(f'{v:.4f}' for v in res[f'{tag}/ms_sharded'])} ms sharded, "
            f"{', '.join(f'{v:.4f}' for v in res[f'{tag}/ms_single'])} ms unsharded")
    if f"{tag}/ms_collectives" in res:
        text += f", its collectives alone {float(res[f'{tag}/ms_collectives']):.4f} ms"
    return text


def held_cli(ranks, what: str):
    """The command lines each rank ran in the world (``worker.py``'s
    ``cli_frame`` and ``cli_implicit``): every return code 0, every epoch's
    checkpoint saved by rank 0 alone."""
    saves = {"cli_frame/train": 1, "cli_frame/resume": 1, "cli_implicit/train": 1}
    runs = sorted({k.rsplit("/", 1)[0] for k in ranks[0] if k.startswith("cli_")})
    for run in runs:
        rcs = [int(r[f"{run}/rc"]) for r in ranks]
        got = [int(r[f"{run}/saves"]) for r in ranks]
        check(rcs == [0] * len(ranks), f"{what} {run}: return codes {rcs}")
        check(got == [saves.get(run, 0)] + [0] * (len(ranks) - 1), f"{what} {run}: saves {got}")
    print(f"{what}: main_frame (--data_parallel train, --resume, --hypothesis_parallel "
          f"{2 if len(ranks) % 2 == 0 else 1} eval-only), main_implicit (train, eval-only) and "
          f"compare over the mesh on every rank: rc 0, checkpoints by rank 0 alone ({runs})")


def parallel_phases(dev, diff, pose, basis, gen, card):
    """Phases 25-27: the sharded steps at full width in a world of 1 rank
    over nccl and of 2 ranks over gloo on cuda:0, then the command line under
    torchrun.  Returns each kernel's launches a rank in the 2-rank world."""
    launches = {}
    # 25. one rank, nccl: every step bit for bit the unsharded one
    spec = parallel_spec(diff, pose, basis, gen)
    ranks, secs = run_world(spec, 1, "world of 1 rank over nccl")
    ref = dict(worker.frame_reference(spec, ranks, dev), **worker.implicit_reference(spec, ranks, dev))
    res = ranks[0]
    for impl, dropout in spec["train_impls"]:
        tag = f"frame/{impl}-{dropout}"
        held_steps(ranks, ref, tag, spec["steps"], exact=True)
        print(f"world 1 (nccl) {tag}: {spec['steps']} sharded steps B={BATCH} bit-equal to the "
              f"unsharded steps; a step {pair_ms(res, tag)}  [{card}]")
    for tt in TEST_TIMES:
        tag = f"frame/eval-data/tt{tt}"
        errs = held_eval(ranks, ref, tag, limits=(0.0, 0.0, 0.0))
        print(f"world 1 (nccl) eval tt={tt} B={BATCH}: bit-equal ({errs}); {pair_ms(res, tag)}  "
              f"[{card}]")
    held_steps(ranks, ref, "implicit/fused", spec["steps"], exact=True, implicit=True)
    tag = "implicit/eval/tt1"
    held_eval(ranks, ref, tag, limits=(0.0, 0.0, 0.0))
    print(f"world 1 (nccl) implicit damped 20/10 B={IMPLICIT_BATCH} (fused, prng): bit-equal; a step "
          f"{pair_ms(res, 'implicit/fused')}; eval (damped {PAR_IMPLICIT_EVAL_ITERS}/"
          f"{PAR_IMPLICIT_EVAL_ITERS}) bit-equal, {pair_ms(res, tag)}  [{card}]")
    held_cli(ranks, "world 1 (nccl)")
    print(f"world 1 (nccl): {secs:.1f} s with the rank's start")

    # 26. two ranks, gloo, both on cuda:0 (an explicit choice: NCCL takes one
    # rank a card); the sweep too, untimed
    spec = dict(spec, device="cuda:0", backend="gloo", steps=PAR_STEPS - 1, time=False,
                sweep=PAR_SWEEP)
    ranks, secs = run_world(spec, 2, "world of 2 ranks over gloo on cuda:0")
    ref = dict(worker.frame_reference(spec, ranks, dev), **worker.implicit_reference(spec, ranks, dev))
    for impl, dropout in spec["train_impls"]:
        tag = f"frame/{impl}-{dropout}"
        w = held_steps(ranks, ref, tag, spec["steps"], exact=False)
        what = "the same step" if dropout == "masks" else "the plain step over the seeds' masks"
        print(f"world 2 (gloo, cuda:0) {tag}: {spec['steps']} steps of B={BATCH // 2} a rank against "
              f"{what} on the concatenated draws: rel loss {w['loss']:.2e}, grad norm "
              f"{w['grad_norm']:.2e}, worst gradient {w['grad']:.2e}, params {w['params']:.2e}")
    tag = "frame/sweep-{}-{}".format(*spec["train_impls"][0])
    loss = np.stack([r[f"{tag}/loss"] for r in ranks])
    want = np.asarray([float(ref[f"{tag}/step{s}/loss"]) for s in range(PAR_SWEEP)])
    lerr = float((np.abs(loss - want) / np.abs(want)).max())
    params = [k for k in ref if k.startswith(f"{tag}/params/")]
    perr = max(float(np.abs(r[k] - ref[k]).max()) for r in ranks for k in params)
    check(lerr <= TOL_STEP_LOSS and perr <= TOL_PIPELINE
          and all(np.array_equal(r[k], ranks[0][k]) for r in ranks for k in params),
          f"{tag}: sweep losses {loss} against {want}, params {perr}")
    print(f"world 2 sweep of {PAR_SWEEP} (each rank its columns of the [S, B] indices): rel loss "
          f"{lerr:.2e}, params {perr:.2e}")
    for name, tts, sel in (("data", TEST_TIMES, None), ("grid", [2], [0])):
        for tt in tts:
            tag = f"frame/eval-{name}/tt{tt}"
            errs = held_eval(ranks, ref, tag, data_ranks=sel)
            if name == "grid":   # both ranks hold every frame and the same mean
                held_eval(ranks, ref, tag, data_ranks=[1])
            print(f"world 2 eval {'(1, 2) data x hypothesis' if name == 'grid' else 'data'} "
                  f"tt={tt}: max|Δ| p1 {errs['p1']:.2e} p2 {errs['p2']:.2e} pred {errs['pred']:.2e}")
    w = held_steps(ranks, ref, "implicit/fused", spec["steps"], exact=False, implicit=True)
    # the damped 20/20 fixed point reaches 150-340 (phase 13): the torch
    # products around the kernels round differently at B=256 than at 512, and
    # the solve amplifies it, so against the whole batch the limit is phase
    # 13's on the eval solve's output
    errs = held_eval(ranks, ref, "implicit/eval/tt1", limits=(TOL_PIPELINE,) * 3)
    print(f"world 2 implicit damped 20/10 (fused, prng) against the mean of the per-shard steps: rel "
          f"loss {w['loss']:.2e}, grad norm {w['grad_norm']:.2e}, worst gradient {w['grad']:.2e}, "
          f"params {w['params']:.2e}, BN {w['bn']:.2e}; eval damped "
          f"{PAR_IMPLICIT_EVAL_ITERS}/{PAR_IMPLICIT_EVAL_ITERS}: max|Δ| {errs}")
    # every kernel's launches on each rank
    per_step = {"frame/fused-masks": ("fwd", "bwd"), "frame/fused-prng": ("fwd_prng", "bwd_prng")}
    for r, res in enumerate(ranks):
        got = {tag: {k: int(res[f"{tag}/launches/{k}"]) for k in worker.COUNTERS}
               for tag in (*per_step, "frame/eval-data/tt1", "implicit/fused", "implicit/eval/tt1")}
        print(f"world 2 rank {r} launches: {got}")
        for tag, keys in per_step.items():
            check(all(got[tag][k] == spec["steps"] for k in keys)
                  and sum(got[tag].values()) == 2 * spec["steps"], f"rank {r} {tag}: {got[tag]}")
        check(got["frame/eval-data/tt1"]["lifter"] == 1
              and got["frame/eval-data/tt1"]["denoiser"] == len(SEQ), f"rank {r} eval: {got}")
        n = PAR_IMPLICIT_SOLVE[1]
        check(got["implicit/fused"]["fwd_prng"] == spec["steps"] * n
              and got["implicit/fused"]["bwd_prng"] == spec["steps"] * n, f"rank {r} implicit: {got}")
        check(got["implicit/eval/tt1"]["lifter"] == 1
              and got["implicit/eval/tt1"]["backbone"] == PAR_IMPLICIT_EVAL_ITERS,
              f"rank {r} implicit eval: {got}")
        launches[r] = got
    held_cli(ranks, "world 2 (gloo, cuda:0)")
    print(f"world 2 (gloo, cuda:0): {secs:.1f} s with the ranks' start")

    # 27. the command line under torchrun, one rank (nccl)
    exp = Path(tempfile.mkdtemp(prefix="chip_smoke_torchrun_"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
           "-m", "diffpose_tpu_torch.cli.main_frame", "--config", CLI_CONFIG, "--exp", str(exp),
           "--doc", "dp", "--ni", "--train", "--n_epochs", "1", "--synthetic_frames",
           str(PAR_CLI_FRAMES), "--batch_size", str(BATCH), "--train_impl", "fused",
           "--dropout_impl", "prng", "--denoiser_impl", "fused", "--data_parallel"]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=PAR_TIMEOUT,
                          cwd=Path(__file__).resolve().parent)
    secs = time.perf_counter() - t0
    check(proc.returncode == 0, f"torchrun main_frame --data_parallel: rc {proc.returncode}\n"
          f"{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    run = exp / "dp"
    steps = -(-PAR_CLI_FRAMES // BATCH)
    files = sorted(f.name for f in run.iterdir())
    want = sorted(["config.yml", f"ckpt_{steps:08d}.pose.pth", f"ckpt_{steps:08d}.pth", "log.tsv",
                   "stdout.txt"])
    check(files == want, f"torchrun run's files {files}, expected {want}")
    rows = (run / "log.tsv").read_text().splitlines()
    log = (run / "stdout.txt").read_text()
    check(len(rows) == 2 and log.count("| Epoch 00") == 1 and "Final" not in log,
          f"torchrun run: log.tsv {rows}")
    print(f"torchrun --nproc_per_node 1 main_frame --train --data_parallel ({PAR_CLI_FRAMES} frames, "
          f"B={BATCH}, 1 epoch): rc 0, files {files}, log.tsv {rows[1]!r}, {secs:.1f} s")
    shutil.rmtree(exp)
    return launches


def video_parallel_spec(basis, gen) -> dict:
    """The video family's sharded steps at the published width of
    ``configs/human36m_video.yml`` (hid 96, 4 layers, 4 heads, 81 frames, 16
    windows a step) with a seeded init: PAR_VIDEO_STEPS train steps, one eval
    batch of 16 windows (2-step DDIM); the meshes are the phases'."""
    model = seeded_video(basis, "cpu", gen, VIDEO_FRAMES)
    data = synthetic_video_dataset(PAR_VIDEO_STEPS * VIDEO_BATCH, VIDEO_FRAMES, seed=SEED + 8)
    return dict(device="cuda", backend="nccl", lr=TRAIN_LR, eps=1e-8, seed=SEED + 10,
                video=dict(cfg=dict(frames=VIDEO_FRAMES, hid_dim=96, num_layers=4, num_heads=4),
                           state={k: v.detach().cpu() for k, v in model.state_dict().items()},
                           batch=VIDEO_BATCH, steps=PAR_VIDEO_STEPS,
                           data={"poses_3d": data.poses_3d, "poses_2d_gmm": data.poses_2d_gmm},
                           eval=dict(batch=video_windows(VIDEO_BATCH, VIDEO_FRAMES, SEED + 9),
                                     test_times=1)))


def held_video_steps(ranks, ref, m: dict, impl: str, dropout: str, exact: bool,
                     loss_rel: float = TOL_VIDEO_LOSS):
    """A video path's train steps against the single-process step on the
    joined draws: bit for bit (``exact``), else loss within ``loss_rel`` and
    the gradient norm within TOL_STEP_GRAD_NORM relative, every gradient entry
    within GRAD_ABS / GRAD_REL, the parameters within TOL_PIPELINE; every
    rank's parameters equal.  Returns the worst errors."""
    part, _, _ = worker.video_part(ranks, m, impl, train=True)
    return held_steps(part, ref, f"video/{m['name']}/train/{impl}-{dropout}",
                      PAR_VIDEO_STEPS, exact=exact, loss_rel=loss_rel)


def held_video_eval(ranks, ref, m: dict, impl: str, limits=(TOL_PIPELINE,) * 3):
    """A video eval's ``[B_local, F_local]`` blocks joined against the
    single-process eval of the whole batch within ``limits`` (P1, P2, pred;
    all 0: bit for bit) and, where only the windows are split, bit for bit
    against the single-process eval of each rank's windows alone (the torch
    products around the kernels round differently at another batch size, and
    the Procrustes alignment of P2 amplifies it).  Returns the errors
    against the whole batch."""
    part, d, c = worker.video_part(ranks, m, impl, train=False)
    errs = {}
    for key, tol in zip(("p1", "p2", "pred"), limits):
        tag = f"video/{m['name']}/eval/{impl}/{key}"
        got = worker.join_blocks([r[tag] for r in part], d, c)
        check(got.shape == ref[tag].shape and bool(np.isfinite(got).all()),
              f"{tag}: shape {got.shape} or non-finite values")
        if f"{tag}_shards" in ref:
            check(np.array_equal(got, ref[f"{tag}_shards"]),
                  f"{tag}: not bit-equal to the single-process eval of each rank's windows")
        errs[key] = float(np.abs(got - ref[tag]).max())
        check(errs[key] <= tol, f"{tag}: max|Δ| {errs[key]:.3e} against the single-process eval "
              f"of the whole batch (limit {tol})")
    return errs


def video_launch_counts(ranks, m: dict, what: str) -> dict:
    """Each rank's kernel launches on each video path of mesh spec ``m``,
    checked against what the path makes: a fused train step one forward and
    one backward launch a layer, a fused eval one row-3 launch a layer and
    DDIM step (and one of row 10 with ``fused_st``), ``fused_full`` one of row
    9; the module step none.  Returns rank 0's by path."""
    layers, n = 4, len(SEQ)
    want = {("fused", "masks"): {"fwd": layers * PAR_VIDEO_STEPS, "bwd": layers * PAR_VIDEO_STEPS},
            ("fused", "prng"): {"fwd_prng": layers * PAR_VIDEO_STEPS,
                                "bwd_prng": layers * PAR_VIDEO_STEPS},
            ("module", "masks"): {},
            "fused": {"backbone": layers * n}, "fused_st": {"backbone": layers * n,
                                                            "temporal": layers * n},
            "fused_full": {"st": layers * n}}
    paths = [(f"train/{i}-{d}", (i, d)) for i, d in m.get("train", ())]
    paths += [(f"eval/{i}", i) for i in m.get("eval", ())]
    out = {}
    for r, res in enumerate(ranks):
        for tag, key in paths:
            got = {k: int(res[f"video/{m['name']}/{tag}/launches/{k}"]) for k in worker.COUNTERS}
            expect = {k: want[key].get(k, 0) for k in worker.COUNTERS}
            check(got == expect, f"{what} rank {r} {tag} launches {got}, expected {expect}")
            if r == 0:
                out[f"video {m['name']} {tag}"] = got
    return out


def video_parallel_phases(dev, basis, gen, card):
    """Phases 28-31: the video family's sharded steps at full width in a world
    of 1 rank over nccl, of 2 ranks (data) and of 3 (context) over gloo on
    cuda:0, the command line under the mesh and under torchrun, then
    ``dryrun_multichip(4)``.  Returns each kernel's launches on rank 0 of the
    2- and 3-rank worlds, by path."""
    from diffpose_tpu_torch.dryrun import dryrun_multichip

    spec = video_parallel_spec(basis, gen)
    launches = {}
    secs = {}

    # 28. one rank, nccl, a (1, 1) data x context mesh: bit for bit the unsharded steps
    t0 = time.perf_counter()
    grid = dict(name="grid1", sizes=(1, 1), names=("data", "context"),
                train=[("fused", "prng")], eval=["fused", "fused_st", "fused_full"])
    one = dict(spec, time=True, video=dict(spec["video"], meshes=[grid]))
    ranks, _ = run_world(one, 1, "video, world of 1 rank over nccl", tasks=("video",))
    ref = worker.video_reference(one, ranks, dev)
    res = ranks[0]
    held_video_steps(ranks, ref, grid, "fused", "prng", exact=True)
    tag = "video/grid1/train/fused-prng"
    print(f"world 1 (nccl, (1, 1) data x context) video train fused prng (rows 7-8, over data): "
          f"{PAR_VIDEO_STEPS} sharded steps of {VIDEO_BATCH}x{VIDEO_FRAMES} bit-equal to the "
          f"unsharded steps; a step {pair_ms(res, tag)}  [{card}]")
    for impl in grid["eval"]:
        held_video_eval(ranks, ref, grid, impl, limits=(0.0, 0.0, 0.0))
        axes = "data x context" if impl == "fused" else "data"
        print(f"world 1 (nccl) video eval {impl} ({axes}) {VIDEO_BATCH}x{VIDEO_FRAMES}: bit-equal "
              f"to the unsharded eval; {pair_ms(res, f'video/grid1/eval/{impl}')}  [{card}]")
    video_launch_counts(ranks, grid, "world 1")
    secs[28] = time.perf_counter() - t0
    print(f"phase 28: {secs[28]:.1f} s")

    # 29. two ranks, gloo, both on cuda:0 (an explicit choice: NCCL takes one rank a card)
    t0 = time.perf_counter()
    data2 = dict(name="data2", sizes=(2,), names=("data",),
                 train=[("fused", "masks"), ("fused", "prng")],
                 eval=["fused", "fused_st", "fused_full"])
    two = dict(spec, device="cuda:0", backend="gloo", video=dict(spec["video"], meshes=[data2]))
    ranks, _ = run_world(two, 2, "video, world of 2 ranks over gloo on cuda:0", tasks=("video",))
    ref = worker.video_reference(two, ranks, dev)
    for impl, dropout in data2["train"]:
        w = held_video_steps(ranks, ref, data2, impl, dropout, exact=False)
        what = ("the same kernels" if dropout == "masks"
                else "the plain stack over the seeds' masks")
        print(f"world 2 (gloo, cuda:0) video train {impl}-{dropout}: {PAR_VIDEO_STEPS} steps of "
              f"{VIDEO_BATCH // 2}x{VIDEO_FRAMES} a rank against {what} on the joined draws: rel "
              f"loss {w['loss']:.2e}, grad norm {w['grad_norm']:.2e}, worst gradient "
              f"{w['grad']:.2e}, params {w['params']:.2e}")
    for impl in data2["eval"]:
        errs = held_video_eval(ranks, ref, data2, impl)
        print(f"world 2 video eval {impl}: max|Δ| p1 {errs['p1']:.2e} p2 {errs['p2']:.2e} pred "
              f"{errs['pred']:.2e}")
    launches.update(video_launch_counts(ranks, data2, "world 2"))
    secs[29] = time.perf_counter() - t0
    print(f"phase 29: {secs[29]:.1f} s")

    # 30. three ranks, gloo on cuda:0, context 3 (81 frames split into 3, 9, 27 or 81
    # parts): 27 frames a rank, the keys and values gathered; then main_video inside it
    t0 = time.perf_counter()
    ctx3 = dict(name="context3", sizes=(3,), names=("context",), train=[("module", "masks")],
                eval=["fused"])
    three = dict(spec, device="cuda:0", backend="gloo",
                 video=dict(spec["video"], meshes=[ctx3],
                            cli=dict(frames=VIDEO_FRAMES, windows=VIDEO_BATCH, batch=VIDEO_BATCH,
                                     flags=["--context_parallel", "3"])))
    ranks, _ = run_world(three, 3, "video, world of 3 ranks over gloo on cuda:0",
                         tasks=("video", "cli_video"))
    ref = worker.video_reference(three, ranks, dev)
    w = held_video_steps(ranks, ref, ctx3, "module", "masks", exact=False)
    print(f"world 3 (gloo, cuda:0, context 3) video train module (dropout 0, K/V gathered): "
          f"{PAR_VIDEO_STEPS} steps of {VIDEO_BATCH}x{VIDEO_FRAMES // 3} a rank against the "
          f"unsharded step on the joined draws: rel loss {w['loss']:.2e}, grad norm "
          f"{w['grad_norm']:.2e}, worst gradient {w['grad']:.2e}, params {w['params']:.2e}")
    errs = held_video_eval(ranks, ref, ctx3, "fused")
    print(f"world 3 video eval fused (row 3 on {VIDEO_BATCH * VIDEO_FRAMES // 3} rows a launch, "
          f"K/V gathered): max|Δ| p1 {errs['p1']:.2e} p2 {errs['p2']:.2e} pred {errs['pred']:.2e}")
    launches.update(video_launch_counts(ranks, ctx3, "world 3"))
    rcs = [[int(r[f"cli_video/{run}/rc"]) for r in ranks] for run in ("train", "eval")]
    saves = [int(r["cli_video/train/saves"]) for r in ranks]
    check(rcs == [[0] * 3] * 2 and saves == [1, 0, 0], f"world 3 main_video --context_parallel 3: "
          f"return codes {rcs}, saves {saves}")
    print(f"world 3 main_video --context_parallel 3 (train 1 epoch, eval-only of its checkpoint, "
          f"--denoiser_impl fused): rc 0 on every rank, checkpoint by rank 0 alone")
    secs[30] = time.perf_counter() - t0

    exp = Path(tempfile.mkdtemp(prefix="chip_smoke_torchrun_video_"))
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", "1",
           "-m", "diffpose_tpu_torch.cli.main_video", "--config", VIDEO_CONFIG, "--exp", str(exp),
           "--doc", "vdp", "--ni", "--train", "--n_epochs", "1", "--synthetic_windows",
           str(VIDEO_BATCH), "--batch_size", str(VIDEO_BATCH), "--denoiser_impl", "fused",
           "--data_parallel", "--context_parallel", "1"]
    t1 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=PAR_TIMEOUT,
                          cwd=Path(__file__).resolve().parent)
    check(proc.returncode == 0, f"torchrun main_video --data_parallel --context_parallel 1: rc "
          f"{proc.returncode}\n{proc.stdout[-3000:]}\n{proc.stderr[-3000:]}")
    files = sorted(f.name for f in (exp / "vdp").iterdir())
    log = (exp / "vdp" / "stdout.txt").read_text()
    check(files == ["ckpt_00000001.pth", "config.yml", "stdout.txt"] and "| Epoch 0000 |" in log,
          f"torchrun main_video: files {files}")
    print(f"torchrun --nproc_per_node 1 main_video --train --data_parallel --context_parallel 1 "
          f"({VIDEO_BATCH} windows, 1 epoch): rc 0, files {files}, "
          f"{time.perf_counter() - t1:.1f} s")
    shutil.rmtree(exp)
    secs[30] = time.perf_counter() - t0
    print(f"phase 30: {secs[30]:.1f} s")

    # 31. the port's dry run over 4 ranks, gloo on cuda:0
    t0 = time.perf_counter()
    line = dryrun_multichip(4, device="cuda:0", backend="gloo", timeout=PAR_TIMEOUT)
    check(line.startswith("dryrun_multichip OK"), f"dryrun_multichip(4): {line}")
    secs[31] = time.perf_counter() - t0
    print(f"phase 31: {secs[31]:.1f} s  [{card}]")
    return launches, secs


# ---------------------------------------------------------------------------
# The reduced kernel tiers (phases 32-33), the utilities (34), the fast eval (35)
# ---------------------------------------------------------------------------


def tier_numbers(got, plain, f32) -> dict:
    """A tier kernel's output against its plain tier version and the float32
    plain version: max and mean |kernel - plain|, the plain tier's max and
    mean distance from f32, the kernel's mean distance from f32."""
    d, t = (got - plain).abs(), (plain - f32).abs()
    return dict(max_abs_err=float(d.max()), mean_abs_err=float(d.mean()),
                tier_max_from_f32=float(t.max()), tier_mean_from_f32=float(t.mean()),
                kernel_mean_from_f32=float((got - f32).abs().mean()))


def tier_ok(rec: dict) -> bool:
    """``tier_numbers`` within the tier's own scale (``TIER_MAX_SHARE`` and
    its siblings say why these bounds)."""
    return (rec["max_abs_err"] <= TIER_MAX_SHARE * rec["tier_max_from_f32"]
            and rec["mean_abs_err"] <= TIER_MEAN_SHARE * rec["tier_mean_from_f32"]
            and rec["kernel_mean_from_f32"] >= TIER_FLOOR_SHARE * rec["tier_mean_from_f32"])


def tier_held(got, plain, f32, what: str) -> dict:
    """A tier kernel's output held to its plain tier version (``tier_ok``);
    returns the numbers."""
    rec = tier_numbers(got, plain, f32)
    print(f"  {what}: max|kernel-plain| {rec['max_abs_err']:.3e} (plain tier from f32 "
          f"{rec['tier_max_from_f32']:.3e}), mean {rec['mean_abs_err']:.3e} (from f32 "
          f"{rec['tier_mean_from_f32']:.3e}; kernel from f32 {rec['kernel_mean_from_f32']:.3e})")
    check(bool(torch.isfinite(got).all()), f"{what}: non-finite output")
    check(tier_ok(rec), f"{what}: the tier kernel is not within its tier's bounds of its plain "
          f"version: {rec}")
    return rec


def p1_mm(pred, target):
    """Per-sample root-centred P1 in mm (``scripts/probe_precision.py:p1``)."""
    pred, target = pred - pred[:, :1], target - target[:, :1]
    return 1000.0 * (pred - target).norm(dim=-1).mean(dim=-1)


def tier_net_phases(dev, basis, wp, wd, g, card):
    """Phase 32: rows 1-3 at both reduced tiers against their plain tier
    versions, timed beside their one-pass bounds; make_eval_fn per tier with
    |dP1| against the float32 pipeline; main_frame eval-only at each tier.
    Returns the tiers records of rows 1, 2 and 3 (row 3's at B=512)."""
    from diffpose_tpu_torch.cli import main_frame
    from diffpose_tpu_torch.ops import fused_denoiser as fd

    recs = {"lifter": {}, "denoiser": {}, "backbone": {}}
    x5 = torch.randn((BATCH * 5, 17, 5), generator=g, device=dev)
    x2 = torch.randn((BATCH, 17, 2), generator=g, device=dev)
    t5 = torch.randint(0, len(BETAS), (BATCH * 5,), generator=g, device=dev).float()
    z = torch.randn((512, 17, 96), generator=g, device=dev)
    tpz = torch.randn((wd["num_layers"], 512, 96), generator=g, device=dev)
    with torch.no_grad():
        tp5 = timestep_projections(wd, t5)
        f32 = {"lifter": net_plain(wp, x2), "denoiser": net_plain(wd, x5, tp5),
               "backbone": backbone_plain(wd, z, tpz)}
        for tier in TIERS:
            wpt, wdt = fd.tier_weights(wp, tier), fd.tier_weights(wd, tier)
            wbt = fd.tier_weights(wd, tier, ends=False)
            print(f"phase 32, tier {tier}: rows 1-3 against their plain {tier} versions")
            cases = (("lifter", BATCH, lambda b: fd._launch(wpt, x2, None),
                      lambda b: net_plain(wpt, x2), lambda b: bound_ms(wpt, b, tier)),
                     ("denoiser", BATCH, lambda b: fd._launch(wdt, x5[:b], tp5[:, :b].contiguous()),
                      lambda b: net_plain(wdt, x5[:b], tp5[:, :b]), lambda b: bound_ms(wdt, b, tier)),
                     ("denoiser", BATCH * 5, lambda b: fd._launch(wdt, x5, tp5),
                      lambda b: net_plain(wdt, x5, tp5), lambda b: bound_ms(wdt, b, tier)),
                     ("backbone", 512, lambda b: fd._launch_backbone(wbt, z, tpz),
                      lambda b: backbone_plain(wbt, z, tpz), lambda b: backbone_bound(wbt, b, tier)))
            for which, b, launch, plain, bound in cases:
                got = launch(b)
                torch.cuda.synchronize()
                ref = f32[which] if which != "denoiser" or b == BATCH * 5 else f32[which][:b]
                rec = tier_held(got, plain(b), ref, f"row {({'denoiser': 1, 'lifter': 2, 'backbone': 3})[which]} "
                                f"({which}) B={b}")
                ms = time_ms(lambda: launch(b))
                bms, by, _ = bound(b)
                print(f"    ms {ms:.4f} (median of 7)  one-pass bound {bms:.4f} ms ({by}; "
                      f"{100 * bms / ms:.1f}%)  [{card}]")
                if b in (BATCH, 512):
                    entry = {"lifter": "ILb0ELb1ELi2ELi3E", "denoiser": "ILb1ELb1ELi5ELi5E",
                             "backbone": "ILb1ELb0ELi96ELi96E"}[which]
                    regs = next(v for k, v in ptxas_usage("net_kernel_tiers").items()
                                if entry in k and k.split(entry)[1].startswith(
                                    f"Li0ELi{1 if tier == 'bf16' else 2}E"))
                    recs[which][tier] = dict(rec, ms=ms, bound_ms=bms, bound_by=by, batch=b,
                                             ptxas=regs)
                else:
                    recs[which][tier].update(ms_b5120=ms, bound_ms_b5120=bms,
                                             max_abs_err_b5120=rec["max_abs_err"])

        # make_eval_fn at tt 1 and 5 per tier: ms and |dP1| against the f32 pipeline
        x2d = 0.3 * torch.randn((BATCH, 17, 2), generator=g, device=dev)
        target = 0.3 * torch.randn((BATCH, 17, 3), generator=g, device=dev)
        dp1 = {}
        for tt in TEST_TIMES:
            pipe = functools.partial(lift_and_denoise, x2d=x2d, seq=SEQ, betas=BETAS, test_times=tt)
            ref = p1_mm(pipe(functools.partial(lifter_plain, wp),
                             functools.partial(denoiser_plain, wd)), target)
            for tier in ("bf16x3", *TIERS):
                wpt, wdt = fd.tier_weights(wp, tier), fd.tier_weights(wd, tier)
                fn = make_eval_fn(basis, seq=SEQ, betas=BETAS, test_times=tt, tier=tier)
                out = fn(wpt, wdt, x2d)
                d = (p1_mm(out, target) - ref).abs()
                ms = time_ms(lambda: fn(wpt, wdt, x2d), reps=5)
                dp1[(tier, tt)] = dict(ms=ms, dp1_mean_mm=float(d.mean()), dp1_max_mm=float(d.max()))
                print(f"make_eval_fn b={BATCH} tt={tt} tier {tier}: {ms:.4f} ms, "
                      f"{BATCH / ms * 1e3:.1f} frames/s; |dP1| against the f32 pipeline mean "
                      f"{float(d.mean()):.4f} mm, max {float(d.max()):.4f} mm  [{card}]")
                check(bool(torch.isfinite(out).all()), f"make_eval_fn tier {tier} tt={tt}")

    # main_frame eval-only at each tier (the tiers' main path)
    exp = Path(tempfile.mkdtemp(prefix="chip_smoke_tiers_"))
    common = ["--config", CLI_CONFIG, "--exp", str(exp), "--ni", "--synthetic_frames",
              str(TIER_CLI_FRAMES), "--batch_size", str(BATCH), "--denoiser_impl", "fused"]
    cli = {}
    for tier, extra in (("bf16", []), ("default", ["--matmul_precision", "default"])):
        reset_launch_counts()
        check(main_frame.main(common + ["--doc", f"eval_{tier}", "--kernel_precision", tier, *extra])
              == 0, f"main_frame eval-only --kernel_precision {tier} failed")
        torch.cuda.synchronize()
        counts = tier_launch_counts()
        print(f"main_frame eval-only --kernel_precision {tier} {' '.join(extra)}: tier launches "
              f"{counts[tier]}, P1/P2 {logged_errors(exp / f'eval_{tier}' / 'stdout.txt')[-1]}")
        check(counts[tier]["lifter"] > 0 and counts[tier]["denoiser"] > 0
              and fused_lifter.launches == 0 and fused_denoiser.launches == 0,
              f"main_frame at {tier} ran the parity kernels or no tier kernel: {counts}, "
              f"parity {fused_lifter.launches, fused_denoiser.launches}")
        cli[tier] = counts[tier]
    logging.getLogger().handlers.clear()
    shutil.rmtree(exp)
    for which in recs:
        for tier in TIERS:
            recs[which][tier]["launches"] = cli[tier][which]
    return recs, dp1


def tier_video_phases(dev, basis, gen, g, card):
    """Phase 33: rows 9-10 (and row 3 at 1,296 video rows) at both reduced
    tiers against their plain tier versions at 16x81, 5x81 and 2x243, timed
    beside their one-pass bounds; main_video eval-only with fused_st and
    fused_full at each tier.  Returns the tiers records of rows 3 (video
    shape), 9 and 10."""
    from diffpose_tpu_torch.cli import main_video
    from diffpose_tpu_torch.ops import fused_video_full as fv

    recs = {"st": {t: {} for t in TIERS}, "temporal": {t: {} for t in TIERS},
            "backbone": {t: {} for t in TIERS}}
    with torch.no_grad():
        for frames, windows in VIDEO_SHAPES:
            m = seeded_video(basis, dev, gen, frames)
            vw = fv.prepare_video_weights(m, dev)
            x = torch.randn((windows, frames, 17, 5), generator=g, device=dev)
            t = torch.randint(0, len(BETAS), (windows,), generator=g, device=dev).float()
            h = fv.embed(vw, x)
            tp = fv.spatial_projections(vw["spatial"], t, frames)[1]
            ht = fv.to_rows(h).contiguous()
            hs = h.reshape(windows * frames, 17, -1)
            f32 = {"temporal": fv.temporal_layer_plain(vw["temporal"], ht, 1),
                   "st": fv.st_layer_plain(vw["layers"], vw["temporal"], h, tp, 1),
                   "backbone": backbone_plain(vw["layers"][1], hs, tp)}
            for tier in TIERS:
                vt = fv.video_tier_weights(vw, tier)
                lw, tw = vt["layers"], vt["temporal"]
                print(f"phase 33, tier {tier}, F={frames} windows={windows}:")
                cases = (("temporal", lambda: fv._launch_temporal(tw, ht, 1),
                          lambda: fv.temporal_layer_plain(tw, ht, 1),
                          lambda: temporal_bound(windows * 17, frames, tier)[0]),
                         ("st", lambda: fv._launch_st(lw, tw, h, tp, 1),
                          lambda: fv.st_layer_plain(lw, tw, h, tp, 1),
                          lambda: st_bound(lw[1], windows, frames, tier)[0]),
                         ("backbone", lambda: _launch_backbone(lw[1], hs, tp),
                          lambda: backbone_plain(lw[1], hs, tp),
                          lambda: backbone_bound(lw[1], windows * frames, tier)))
                for which, launch, plain, bound in cases:
                    if which == "backbone" and (frames, windows) != (VIDEO_FRAMES, VIDEO_BATCH):
                        continue
                    got = launch()
                    torch.cuda.synchronize()
                    row = {"temporal": 10, "st": 9, "backbone": 3}[which]
                    rec = tier_held(got, plain(), f32[which], f"row {row}")
                    ms = time_ms(launch)
                    bms, by, _ = bound()
                    print(f"    ms {ms:.4f} (median of 7)  one-pass bound {bms:.4f} ms ({by}; "
                          f"{100 * bms / ms:.1f}%)  [{card}]")
                    tag = f"{windows}x{frames}"
                    if (frames, windows) == (VIDEO_FRAMES, VIDEO_BATCH):
                        recs[which][tier].update(rec, ms=ms, bound_ms=bms, bound_by=by, shape=tag)
                    else:
                        recs[which][tier].update({f"ms_{tag}": ms, f"bound_ms_{tag}": bms,
                                                  f"max_abs_err_{tag}": rec["max_abs_err"]})
        for tier in TIERS:
            for which, kernel in (("temporal", "temporal"), ("st", "st")):
                occ = fv.kernel_occupancy(dev, kernel, tier)
                recs[which][tier]["occupancy"] = occ
            usage = ptxas_usage("video_kernel_tiers")
            code = 1 if tier == "bf16" else 2
            for which, name in (("temporal", "temporal_kernel"), ("st", "st_layer_kernel")):
                recs[which][tier]["ptxas"] = next(v for k, v in usage.items()
                                                  if f"{name}ILi{code}E" in k)

    exp = Path(tempfile.mkdtemp(prefix="chip_smoke_video_tiers_"))
    common = ["--config", VIDEO_CONFIG, "--exp", str(exp), "--ni", "--synthetic_windows",
              str(TIER_CLI_WINDOWS)]
    for tier in TIERS:
        for impl, kernels in (("fused_st", ("backbone", "temporal")), ("fused_full", ("st",))):
            reset_launch_counts()
            check(main_video.main(common + ["--doc", f"{impl}_{tier}", "--denoiser_impl", impl,
                                            "--kernel_precision", tier]) == 0,
                  f"main_video eval-only {impl} --kernel_precision {tier} failed")
            torch.cuda.synchronize()
            counts = tier_launch_counts()[tier]
            print(f"main_video eval-only {impl} --kernel_precision {tier}: tier launches {counts}, "
                  f"P1/P2 {logged_errors(exp / f'{impl}_{tier}' / 'stdout.txt')[-1]}")
            check(all(counts[k] > 0 for k in kernels) and fused_st_layer.launches == 0
                  and fused_temporal_layer.launches == 0 and fused_backbone.launches == 0,
                  f"main_video {impl} at {tier}: {counts}")
            for k in kernels:
                recs[k][tier]["launches"] = recs[k][tier].get("launches", 0) + counts[k]
    logging.getLogger().handlers.clear()
    shutil.rmtree(exp)
    return recs


def utils_phases(dev, basis, wp, wd, g, card):
    """Phase 34: the utilities on the card: the memory budget and the batch
    it suggests, trace_profile around a fused eval batch inside a span,
    whose trace must name the span and the row-1 kernel."""
    from diffpose_tpu_torch.utils import span, trace_profile
    from diffpose_tpu_torch.utils.memory import (device_memory_budget, estimate_per_sample_bytes,
                                                 suggest_batch_size)

    budget = device_memory_budget(dev)
    batch = suggest_batch_size(estimate_per_sample_bytes(), device=dev)
    print(f"phase 34: device_memory_budget {budget} bytes ({budget / 2 ** 30:.2f} GiB), "
          f"suggest_batch_size(estimate_per_sample_bytes()) {batch}  [{card}]")
    check(budget > 0 and batch % 8 == 0 and 8 <= batch <= 65536, "memory utilities")
    fn = make_eval_fn(basis, seq=SEQ, betas=BETAS, test_times=1)
    x2d = torch.randn((BATCH, 17, 2), generator=g, device=dev)
    with torch.no_grad():
        fn(wp, wd, x2d)
        path = Path(tempfile.mkdtemp(prefix="chip_smoke_utils_"))
        sees = profiler_sees_device()
        found = False
        for attempt in range(3 if sees else 1):   # the profiler now and then loses a kernel's record
            with trace_profile(str(path / "trace")):
                with span("chip_smoke.eval"):
                    fn(wp, wd, x2d)
            names = {e.get("name", "") for e in
                     json.loads((path / "trace" / "trace.json").read_text())["traceEvents"]}
            found = any("net_forward_kernel" in n for n in names)
            if found:
                break
        print(f"trace_profile: {len(names)} event names, the row-1 kernel named: {found} "
              f"(attempt {attempt + 1}), the span named: {'chip_smoke.eval' in names}")
        check("chip_smoke.eval" in names, "trace_profile's trace names no program span")
        if sees:
            check(found, "trace_profile's trace names no net_forward_kernel")
        else:   # the profiler lost kernel records in this process: only the host side is held
            print("trace_profile: torch.profiler is not trusted in this process; the trace's "
                  "kernel names not checked, its host events are")
            check(any("aten::" in n for n in names), "trace_profile's trace holds no host event")
    shutil.rmtree(path)
    return dict(budget_bytes=budget, suggested_batch=batch)


def fast_eval_phases(dev, pose, diff, wd, g, card):
    """Phase 35: the BigW fast eval at B=1024 against the module forward (f32
    within TOL_FAST) and in bf16, timed beside row 1."""
    from diffpose_tpu_torch.ops import make_fast_denoiser, make_fast_lifter

    x = torch.randn((BATCH, 17, 5), generator=g, device=dev)
    x2 = torch.randn((BATCH, 17, 2), generator=g, device=dev)
    t = torch.randint(0, len(BETAS), (BATCH,), generator=g, device=dev).float()
    rec = {}
    with torch.no_grad():
        want, want2 = diff(x, t), pose(x2)
        for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            den = make_fast_denoiser(diff, dtype=dtype, device=dev)
            lift = make_fast_lifter(pose, dtype=dtype, device=dev)
            got, got2 = den(x, t), lift(x2)
            e, e2 = max_err(got, want), max_err(got2, want2)
            ms = time_ms(lambda: den(x, t))
            rec[name] = dict(max_abs_err=e, lifter_max_abs_err=e2, ms=ms)
            print(f"phase 35: fast eval {name} B={BATCH}: denoiser max|fast-module| {e:.3e}, lifter "
                  f"{e2:.3e}, |out| max {float(want.abs().max()):.3f}; {ms:.4f} ms a denoiser call  "
                  f"[{card}]")
            check(got.dtype == torch.float32 and bool(torch.isfinite(got).all()), f"fast eval {name}")
            if name == "f32":
                check(e <= TOL_FAST and e2 <= TOL_FAST, f"fast eval f32 against the module: {e}, {e2}")
        tp = timestep_projections(wd, t)
        rec["row1_ms"] = time_ms(lambda: _launch(wd, x, tp))
    print(f"  row 1 at B={BATCH}: {rec['row1_ms']:.4f} ms; fast f32 / row 1 "
          f"{rec['f32']['ms'] / rec['row1_ms']:.2f}, fast bf16 / row 1 "
          f"{rec['bf16']['ms'] / rec['row1_ms']:.2f}  [{card}]")
    return rec


# ---------------------------------------------------------------------------
# The train kernels' reduced tiers (phases 36-37)
# ---------------------------------------------------------------------------


def tier_held_all(got: dict, plain: dict, f32: dict, what: str) -> dict:
    """``tier_held`` on every tensor of ``got`` (each against the same key of
    the plain tier version and of the float32 plain version), printed as one
    line of the worst shares of the plain tier's distance from f32; returns
    them.  A tensor that no rounding of the tier reaches (its plain tier
    version equals the float32 one, as a one-layer stack's first stashes do)
    has no tier scale: it is held to the parity grade's bounds instead
    (``TOL_KERNEL``, or ``grad_close`` under ``GRAD_REL``)."""
    recs = {k: tier_numbers(got[k], plain[k], f32[k]) for k in got}
    live = [k for k, r in recs.items() if r["tier_mean_from_f32"] > 0]   # the tier rounded it
    for k in set(recs) - set(live):
        check(recs[k]["max_abs_err"] <= TOL_KERNEL or grad_close(got[k], plain[k]) < GRAD_REL,
              f"{what} {k} (not rounded at the tier): {recs[k]}")

    def worst(num, den, pick=max):
        k = pick(live, key=lambda k: recs[k][num] / recs[k][den])
        return recs[k][num] / recs[k][den], k

    (mx, kx), (mn, kn), (fl, kf) = (worst("max_abs_err", "tier_max_from_f32"),
                                    worst("mean_abs_err", "tier_mean_from_f32"),
                                    worst("kernel_mean_from_f32", "tier_mean_from_f32", min))
    rec = dict(max_abs_err=max(r["max_abs_err"] for r in recs.values()), max_share=mx,
               mean_share=mn, floor_share=fl, tensors=len(recs), not_rounded=len(recs) - len(live))
    print(f"  {what}: {len(recs)} tensors ({rec['not_rounded']} not rounded at the tier), "
          f"max|kernel-plain| {rec['max_abs_err']:.3e}; worst shares of the plain tier's distance "
          f"from f32: max {mx:.3f} ({kx}), mean {mn:.3f} ({kn}); least kernel-from-f32 share "
          f"{fl:.3f} ({kf})")
    for k, r in recs.items():
        check(bool(torch.isfinite(got[k]).all()), f"{what} {k}: non-finite output")
        check(k not in live or tier_ok(r), f"{what} {k}: the tier kernel is not within its tier's "
              f"bounds of its plain version: {r}")
    return rec


def tier_train_shapes(dev, basis, diff, gen, g):
    """Rows 5-8's three main-path shapes: (tag, weights, h0, tp, rates): the
    frame stack at B=1024, the implicit stack at B=512, a video spatial block
    (one layer) at 1,296 rows."""
    from diffpose_tpu_torch.ops import fused_video_full as fv
    from diffpose_tpu_torch.ops import fused_video_train as fvt

    shapes = []
    w = prepare_weights(diff, dev)
    x = torch.randn((BATCH, 17, 5), generator=g, device=dev)
    t = torch.randint(0, len(BETAS), (BATCH,), generator=g, device=dev).float()
    with torch.no_grad():
        tp = timestep_projections(w, t)
        h0 = _cheb(x, w["win"], w["bin"], w["basis"]).contiguous()
    shapes.append((f"B={BATCH}", w, h0, tp, None))
    wi = prepare_weights(seeded_igcn(basis, dev, gen), dev)
    shapes.append((f"B={IMPLICIT_BATCH}", wi,
                   torch.randn((IMPLICIT_BATCH, 17, 96), generator=g, device=dev),
                   torch.randn((wi["num_layers"], IMPLICIT_BATCH, 96), generator=g, device=dev),
                   None))
    video = seeded_video(basis, dev, gen, VIDEO_FRAMES)
    wv = fv.layer_weights(prepare_weights(fv.SpatialBlocks(video), dev))[0]
    rows = VIDEO_BATCH * VIDEO_FRAMES
    shapes.append((f"{rows} rows x 1 layer", wv, torch.randn((rows, 17, 96), generator=g, device=dev),
                   torch.randn((1, rows, 96), generator=g, device=dev),
                   fvt.video_dropout_rates(video)))
    return shapes


def tier_train_phases(dev, basis, diff, gen, g, card):
    """Phase 36: rows 5-8 at both reduced tiers against their plain tier
    versions at the three main-path shapes (the seeded pair's masks dumped
    and handed to the plain versions; the backward given the plain tier
    forward's stashes), every output and weight gradient held to the tier's
    own scale, each kernel timed beside its one-pass bound.  Returns
    {tier: {kind: record}} for the kernels' JSON line."""
    recs = {tier: {k: {} for k in ("fwd", "bwd", "fwd_prng", "bwd_prng")} for tier in TIERS}
    seed = torch.tensor([SEED + 36], dtype=torch.int32, device=dev)
    usage = ptxas_usage("train_kernel_tiers")
    for tag, w, h0, tp, rates in tier_train_shapes(dev, basis, diff, gen, g):
        L, bsz = w["num_layers"], h0.shape[0]
        ikeep = ft._inv_keep(rates)
        km = ft.kernel_masks(make_dropout_masks(g, num_layers=L, n_pts=17, batch=bsz, num_heads=4,
                                                hid_dim=96, rates=rates))
        dd5 = torch.randn((bsz, 17, 96), generator=g, device=dev)
        for tier in TIERS:
            print(f"phase 36, tier {tier}, {tag}: rows 5-8 against their plain {tier} versions")
            for prng in (False, True):
                if prng:
                    drop = ft._seeded(seed, rates)
                    d5, st, masks = ft._launch_fwd(w, h0, tp, drop, ikeep, dump=True, tier=tier)
                else:
                    drop = masks = km
                    d5, st = ft._launch_fwd(w, h0, tp, km, ikeep, tier=tier)
                torch.cuda.synchronize()
                with torch.no_grad():
                    d5t, stt = ft.plain_fwd(w, h0, tp, masks, rates=rates, tier=tier)
                    d5f, stf = ft.plain_fwd(w, h0, tp, masks, rates=rates)
                mode = "prng" if prng else "masks"
                fwd = tier_held_all({"d5": d5, **st}, {"d5": d5t, **stt}, {"d5": d5f, **stf},
                                    f"row {7 if prng else 5} fwd ({mode})")
                sts = {k: v.contiguous() for k, v in stt.items()}
                da0, dtp, ds = ft._launch_bwd(w, drop, sts, dd5, ikeep, tier=tier)
                torch.cuda.synchronize()
                with torch.no_grad():
                    plain = ft.plain_bwd(w, masks, sts, dd5, rates=rates, tier=tier)
                    f32 = ft.plain_bwd(w, masks, sts, dd5, rates=rates)
                    outs = [dict(da0=o[0], dtp=o[1], **o[2], **{
                        f"grad_{k}": v for k, v in ft.weight_grads(w, sts, o[2]).items()})
                        for o in ((da0, dtp, ds), plain, f32)]
                bwd = tier_held_all(*outs, f"row {8 if prng else 6} bwd ({mode})")
                for kind, rec in ((f"fwd{'_prng' if prng else ''}", fwd),
                                  (f"bwd{'_prng' if prng else ''}", bwd)):
                    recs[tier][kind][tag] = rec
                del outs, plain, f32, stt, stf, sts
            ms, bounds = train_pair_times(w, h0, tp, seed, g, rates, card, tag, tier=tier)
            for kind in ("fwd", "bwd"):
                for masks_mode, suffix in ((True, ""), (False, "_prng")):
                    bms, by, _ = bounds[(kind, masks_mode)]
                    recs[tier][kind + suffix][tag].update(ms=ms[(kind, masks_mode)], bound_ms=bms,
                                                          bound_by=by)
    out = {}
    for tier in TIERS:
        out[tier] = {}
        for kind, by_shape in recs[tier].items():
            main, b512, video = (by_shape[k] for k in by_shape)     # the shapes in order
            entry = (f"train_{'forward' if kind.startswith('fwd') else 'backward'}_kernelILb"
                     f"{int(kind.endswith('prng'))}ELi{TIER_CODES[tier]}E")
            out[tier][kind] = dict(
                ms=main["ms"], bound_ms=main["bound_ms"], bound_by=main["bound_by"],
                max_abs_err=main["max_abs_err"], shares={k: main[k] for k in (
                    "max_share", "mean_share", "floor_share")},
                ms_b512=b512["ms"], bound_ms_b512=b512["bound_ms"],
                max_abs_err_b512=b512["max_abs_err"], ms_video=video["ms"],
                bound_ms_video=video["bound_ms"], max_abs_err_video=video["max_abs_err"],
                ptxas=next(v for k, v in usage.items() if entry in k))
    return out


def tier_step_grads(kind: str, model, draws, tier: str, how: str, basis):
    """The output and the first step's raw gradients (before the clip, as one
    vector) of ``kind``'s training forward on ``draws`` (explicit masks):
    ``how`` "fused" (the tier's kernels), "plain" (their plain tier versions
    behind the same autograd function) or "f32" (the parity grade's plain
    stack)."""
    from diffpose_tpu_torch.ops import fused_video_train as fvt

    m = copy.deepcopy(model).train()
    t = draws.t.to(torch.float32)
    cfg = dict(num_layers=m.num_layers, num_heads=m.num_heads, hid_dim=m.hid_dim)
    if how == "f32":
        tier, how = "bf16x3", "plain"
    if kind == "frame":
        stack = ft.build_train_stack(basis, **cfg, tier=tier, plain=how == "plain")
        out = ft.fused_train_forward(m, draws.x_t, t, draws.masks, stack)
        loss = ((draws.e - out) ** 2).sum(dim=(1, 2)).mean()
    elif kind == "implicit":
        stack = ft.build_train_stack(basis, **cfg, tier=tier, plain=True) if how == "plain" else None
        out = make_igcn_train_fn(m, dropout="masks", stack=stack, tier=tier)(draws.x_t, t,
                                                                              draws.masks)[0]
        loss = ((draws.e - out) ** 2).sum(dim=(1, 2)).mean()
    else:
        out = fvt.make_video_train_fn(m, dropout="masks", tier=tier, plain=how == "plain")(
            draws.x_t, t, draws.masks, draws.tmasks)
        loss = ((draws.e - out) ** 2).sum(dim=(1, 2, 3)).mean()
    grads = torch.autograd.grad(loss, list(m.parameters()))
    return {"out": out.detach(), "grads": torch.cat([v.reshape(-1) for v in grads])}


def tier_train_step_phases(dev, basis, diff, gen, g, card):
    """Phase 37: for each family one fused step against one plain step at
    each tier (explicit masks; the output and the first step's gradients
    held to the tier's own scale against the parity grade's plain step on
    the same draws); then a short ``--train_impl fused --dropout_impl prng``
    run of main_frame, main_implicit and main_video at each tier: exit 0, a
    finite loss, the default tier's warning in the frame and implicit logs,
    the video family's default run on the parity build only.  Returns the
    tier launches of rows 5-8: rows 5-6 from the fused steps, rows 7-8 from
    the frame run."""
    from diffpose_tpu_torch.cli import main_frame, main_implicit, main_video
    from diffpose_tpu_torch.data.synthetic import make_synthetic_dataset as synth
    from diffpose_tpu_torch.train.video_steps import make_video_train_step

    launches = {t: {} for t in TIERS}
    fams = []
    data = synth(num_frames=BATCH, seed=SEED + 37)
    batch = {"poses_3d": torch.as_tensor(data.poses_3d, device=dev),
             "poses_2d_gmm": torch.as_tensor(data.poses_2d_gmm, device=dev)}
    fams.append(("frame", diff, make_draw(BETAS, dev, num_layers=diff.num_layers, num_heads=4,
                                          hid_dim=96, dropout="masks", masks_dtype=torch.uint8),
                 batch))
    igcn = with_solver(seeded_igcn(basis, dev, gen), *PAR_IMPLICIT_SOLVE)
    fams.append(("implicit", igcn, make_draw(BETAS, dev, num_layers=igcn.num_layers, num_heads=4,
                                             hid_dim=96, dropout="masks",
                                             masks_dtype=torch.uint8),
                 {k: v[:IMPLICIT_BATCH] for k, v in batch.items()}))
    video = seeded_video(basis, dev, gen, VIDEO_FRAMES)
    vopt = make_optimizer(video.parameters(), lr=TRAIN_LR)
    vstep = make_video_train_step(video, vopt, BETAS, impl="fused", device=dev, dropout="masks")
    fams.append(("video", video, vstep.draw, video_windows(VIDEO_BATCH, VIDEO_FRAMES, SEED + 37)))
    for kind, model, draw, b in fams:
        draws = draw(b, torch.Generator(device=dev).manual_seed(SEED + 37))
        f32 = tier_step_grads(kind, model, draws, "bf16x3", "f32", basis)
        for tier in TIERS:
            reset_launch_counts()
            got = tier_step_grads(kind, model, draws, tier, "fused", basis)
            torch.cuda.synchronize()
            counts = train_tier_counts()
            plain = tier_step_grads(kind, model, draws, tier, "plain", basis)
            print(f"phase 37, tier {tier}: the {kind} step, fused against plain (launches "
                  f"{counts[tier]})")
            tier_held_all(got, plain, f32, f"{kind} step")
            check(counts[tier]["fwd"] > 0 and counts[tier]["bwd"] > 0
                  and counts["bf16x3"]["fwd"] == counts["bf16x3"]["bwd"] == 0,
                  f"the fused {kind} step at {tier} ran the parity build or no tier kernel: {counts}")
            for k in ("fwd", "bwd"):
                launches[tier][f"{k}_{kind}_step"] = counts[tier][k]
            del got, plain
        del f32

    exp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_tiers_"))
    runs = (("frame", main_frame, ["--config", CLI_CONFIG, "--synthetic_frames", str(TIER_CLI_FRAMES),
                                   "--batch_size", str(BATCH)]),
            ("implicit", main_implicit, ["--config", IMPLICIT_CONFIG, "--use_implicit",
                                         "--synthetic_frames", str(2 * IMPLICIT_BATCH),
                                         "--batch_size", str(IMPLICIT_BATCH)]),
            ("video", main_video, ["--config", VIDEO_CONFIG, "--synthetic_windows",
                                   str(TIER_CLI_WINDOWS)]))
    for kind, cli, args in runs:
        for tier in TIERS:
            doc = f"{kind}_{tier}"
            reset_launch_counts()
            check(cli.main(args + ["--exp", str(exp), "--doc", doc, "--ni", "--train", "--n_epochs",
                                   "1", "--train_impl", "fused", "--dropout_impl", "prng",
                                   "--denoiser_impl", "fused", "--kernel_precision", tier]) == 0,
                  f"main_{kind} --train --kernel_precision {tier} failed")
            torch.cuda.synchronize()
            counts = train_tier_counts()
            log = (exp / doc / "stdout.txt").read_text()
            losses = [float(v) for v in re.findall(r"\| loss ([0-9.eE+-]+|nan|inf) \|", log)]
            warned = "TRAIN kernels" in log
            print(f"main_{kind} --train --kernel_precision {tier}: epoch losses {losses}, default-tier "
                  f"warning {warned}, seeded launches by build {counts}")
            check(len(losses) == 1 and all(v == v and abs(v) != float("inf") for v in losses),
                  f"main_{kind} at {tier}: epoch losses {losses}")
            trains_at = "bf16x3" if kind == "video" and tier == "default" else tier
            check(warned == (kind != "video" and tier == "default"),
                  f"main_{kind} at {tier}: the default-tier warning {'missing' if not warned else 'given'}")
            others = [t for t in ("bf16x3", *TIERS) if t != trains_at]
            check(counts[trains_at]["fwd_prng"] > 0 and counts[trains_at]["bwd_prng"] > 0
                  and all(counts[t]["fwd_prng"] == counts[t]["bwd_prng"] == 0 for t in others),
                  f"main_{kind} at {tier} trained on another build than {trains_at}: {counts}")
            if kind == "frame":
                for k in ("fwd_prng", "bwd_prng"):
                    launches[tier][k] = counts[tier][k]
    logging.getLogger().handlers.clear()
    shutil.rmtree(exp)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()
    print(f"torch {torch.__version__} cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}")
    print(f"torch.profiler records this process's kernels: {profiler_sees_device()}; device times "
          f"by {device_clock()} until a trace loses a record")

    # 1. build (and the clock-stamped build of rows 9-10 that phase 17 reads)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(1) as pool:
        stamped = pool.submit(video_phases.build)
        libs = _build.build_all()
        stamped.result()
    print(f"build: {time.perf_counter() - t0:.1f} s for {sorted(libs)} and rows 9-10 with "
          f"clock stamps")
    for name in libs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {name}: {line.strip()}")
    spills = [l for l in _build.build_log("train_kernel").splitlines() if "spill" in l]
    check(len(spills) == 4 and all("0 bytes spill stores, 0 bytes spill loads" in l for l in spills),
          f"the train kernels spill registers: {spills}")
    # every build of net_forward_kernel (rows 1-3 and the probe's six), row 9,
    # whose spatial phase is its layer, and rows 4 and 12 (registers: the lines above)
    for name, entries in (("net_kernel", 3), ("probe_kernel", 6), ("video_kernel", 2),
                          ("cheb_kernel", 7), ("probe_attention", 2), ("net_kernel_tiers", 6),
                          ("video_kernel_tiers", 4), ("train_kernel_tiers", 8)):
        check_no_spills(name, entries)
    print(f"  dynamic shared memory of every net_forward_kernel build and of row 9: "
          f"{ablate._library().probe_smem_bytes()} bytes")

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
        for bsz in (BATCH, 1000, BATCH * 5):
            x = randn(bsz, 17, 2)
            got = _launch(wp, x, None)
            torch.cuda.synchronize()
            e_plain = max_err(got, net_plain(wp, x))
            e_mod = max_err(got, pose(x))
            print(f"lifter   B={bsz:5d}: max|kernel-plain| {e_plain:.3e}  max|kernel-module| {e_mod:.3e}")
            check(e_plain <= TOL_KERNEL and e_mod <= TOL_KERNEL, f"lifter B={bsz}")
            errs["lifter"] = max(errs["lifter"], e_plain)
            inputs.setdefault("lifter", (x, None))
        for bsz in (BATCH, 1000, BATCH * 5):
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
        card = card_line()
        x, _ = inputs["lifter"]
        ms = time_ms(lambda: _launch(wp, x, None))
        plain_ms = time_ms(lambda: net_plain(wp, x))
        bms, by, bms32 = bound_ms(wp, BATCH)
        print(f"lifter   B={BATCH}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  bound {bms:.4f} ms "
              f"({by}; {100 * bms / ms:.1f}%)  FP32-only bound {bms32:.4f} ms "
              f"({100 * bms32 / ms:.1f}%)  [{card}]")
        kernels.append(dict(
            name="net_kernel[lifter]", route="cuda", source="diffpose_tpu_torch/csrc/net_kernel.cu",
            replaces="diffpose_tpu/ops/pallas_denoiser.py:276", launches=launches["lifter"],
            max_abs_err=errs["lifter"], ms=ms, plain_ms=plain_ms, bound_ms=bms, bound_by=by,
            library_ms=None, bound_ms_fp32=bms32, ptxas=net_ptxas("lifter"), batch=BATCH))
        for bsz in (BATCH, BATCH * 5):
            x, tp = inputs[("denoiser", bsz)]
            ms = time_ms(lambda: _launch(wd, x, tp))
            plain_ms = time_ms(lambda: net_plain(wd, x, tp))
            bms, by, bms32 = bound_ms(wd, bsz)
            print(f"denoiser B={bsz}: kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  "
                  f"bound {bms:.4f} ms ({by}; {100 * bms / ms:.1f}%)  FP32-only bound "
                  f"{bms32:.4f} ms ({100 * bms32 / ms:.1f}%)  "
                  f"{net_flops(wd, bsz) / ms / 1e9:.1f} TFLOP/s  [{card}]")
            if bsz == BATCH:
                kernels.append(dict(
                    name="net_kernel[denoiser]", route="cuda",
                    source="diffpose_tpu_torch/csrc/net_kernel.cu",
                    replaces="diffpose_tpu/ops/pallas_denoiser.py:276",
                    launches=launches["denoiser"], max_abs_err=errs["denoiser"], ms=ms,
                    plain_ms=plain_ms, bound_ms=bms, bound_by=by, library_ms=None,
                    bound_ms_fp32=bms32, ptxas=net_ptxas("denoiser"), batch=bsz))
            else:
                kernels[-1].update(ms_b5120=ms, bound_ms_b5120=bms, bound_ms_fp32_b5120=bms32)
        for tt in TEST_TIMES:
            ms = time_ms(lambda: evals[tt](wp, wd, x2d), reps=5)
            pipe = functools.partial(lift_and_denoise, x2d=x2d, seq=SEQ, betas=BETAS, test_times=tt)
            plain_ms = time_ms(lambda: pipe(functools.partial(lifter_plain, wp),
                                            functools.partial(denoiser_plain, wd)), reps=3)
            print(f"eval b={BATCH} tt={tt}: {ms:.4f} ms, {BATCH / ms * 1e3:.1f} frames/s "
                  f"(plain pipeline {plain_ms:.4f} ms, {BATCH / plain_ms * 1e3:.1f} frames/s)")

    ctx, train_records = train_phases(dev, basis, diff, g)
    kernels += train_records
    prng_records = prng_phases(dev, diff, g, ctx, card)
    cli_counts = cli_phases(card)

    t_implicit = time.perf_counter()
    backbone_record, implicit_pair = implicit_kernel_phases(dev, basis, gen, g, card)
    implicit_counts = implicit_cli_phases(card)
    t_video = time.perf_counter()
    row9, row10, masks_launches, row3_video, video_pair = video_kernel_phases(dev, basis, gen, g, card)
    video_runs = video_cli_phases(card)
    t_graformer = time.perf_counter()
    row4 = graformer_phases(dev, gen, g, card)
    row11 = ablate_phases(dev, wd, g, card)
    row12 = attention_probe_phases(card)
    t_parallel = time.perf_counter()
    par_launches = parallel_phases(dev, diff, pose, basis, gen, card)
    t_video_parallel = time.perf_counter()
    video_launches, video_secs = video_parallel_phases(dev, basis, gen, card)
    t_tiers = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False   # the runners' --matmul_precision restores it
    with torch.no_grad():
        net_tiers, dp1 = tier_net_phases(dev, basis, wp, wd, g, card)
        video_tiers = tier_video_phases(dev, basis, gen, g, card)
        utils_rec = utils_phases(dev, basis, wp, wd, g, card)
        fast = fast_eval_phases(dev, pose, diff, wd, g, card)
    t_train_tiers = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    train_tiers = tier_train_phases(dev, basis, diff, gen, g, card)
    train_tier_launches = tier_train_step_phases(dev, basis, diff, gen, g, card)
    t_end = time.perf_counter()
    video = video_runs["train"]
    for rec, key in zip(prng_records, ("fwd_prng", "bwd_prng")):
        kernels.append(dict(rec, launches=cli_counts[key], implicit_launches=implicit_counts[key],
                            video_launches=video[key]))
    for rec, key in zip(kernels[2:4], ("fwd", "bwd")):
        rec["video_launches"] = masks_launches[key]     # phase 19's explicit-mask steps
    # rows 5-8: the other two main-path shapes, and ptxas' resources
    usage = ptxas_usage("train_kernel")
    for rec, kind, masks in zip(kernels[2:6], ("fwd", "bwd", "fwd", "bwd"), (True, True, False, False)):
        for tag, (pair_ms, pair_bounds) in (("b512", implicit_pair), ("video", video_pair)):
            rec[f"ms_{tag}"] = pair_ms[(kind, masks)]
            rec[f"bound_ms_{tag}"], _, rec[f"bound_ms_fp32_{tag}"] = pair_bounds[(kind, masks)]
        entry = f"train_{'forward' if kind == 'fwd' else 'backward'}_kernelILb{0 if masks else 1}"
        rec["ptxas"] = next(v for k, v in usage.items() if entry in k)
    # rows 5-8's tiers (phase 36) and their launches (phase 37: rows 5-6 in the
    # fused steps, the frame step's as the main path's; rows 7-8 in main_frame --train)
    for rec, kind in zip(kernels[2:6], ("fwd", "bwd", "fwd_prng", "bwd_prng")):
        rec["tiers"] = {}
        for tier in TIERS:
            n = train_tier_launches[tier]
            by_step = {f: n[f"{kind}_{f}_step"] for f in ("frame", "implicit", "video")
                       if f"{kind}_{f}_step" in n}
            rec["tiers"][tier] = dict(train_tiers[tier][kind],
                                      launches=n[kind] if kind in n else by_step["frame"],
                                      **({"launches_by_step": by_step} if by_step else {}))
    kernels.insert(2, dict(backbone_record, launches=implicit_counts["backbone"],
                           video_launches=video["backbone"], ptxas=net_ptxas("backbone"),
                           **row3_video))
    kernels.append(dict(row9, launches=video_runs["fused_full"]["st"],
                        main_path="main_video eval-only --denoiser_impl fused_full",
                        tiers=video_tiers["st"]))
    kernels.append(dict(row10, launches=video_runs["fused_st"]["temporal"],
                        main_path="main_video eval-only --denoiser_impl fused_st",
                        tiers=video_tiers["temporal"]))
    # rows 1-3's tiers (phase 32; row 3 also at the video shape, phase 33)
    for rec, which in zip(kernels[:3], ("lifter", "denoiser", "backbone")):
        rec["tiers"] = net_tiers[which]
        if which == "backbone":   # its tier main path: main_video eval-only fused_st
            for tier in TIERS:
                vt = video_tiers["backbone"][tier]
                rec["tiers"][tier].update(ms_video=vt["ms"], bound_ms_video=vt["bound_ms"],
                                          max_abs_err_video=vt["max_abs_err"],
                                          launches=vt["launches"])
    kernels[1]["eval_tiers"] = {f"{t}_tt{tt}": v for (t, tt), v in dp1.items()}
    kernels[1]["fast_eval"] = fast
    kernels += [row4, row11, row12]
    # each kernel's launches on one rank of phase 26's 2-rank world, by step, and of
    # phases 29-30's video worlds, by path
    counter = {"net_kernel[lifter]": "lifter", "net_kernel[denoiser]": "denoiser",
               "net_kernel[backbone]": "backbone", "train_kernel[fwd]": "fwd",
               "train_kernel[bwd]": "bwd", "train_kernel[fwd,prng]": "fwd_prng",
               "train_kernel[bwd,prng]": "bwd_prng", "video_kernel[st_layer]": "st",
               "video_kernel[temporal]": "temporal"}
    for rec in kernels:
        if rec["name"] in counter:
            k = counter[rec["name"]]
            rec["sharded_launches_per_rank"] = {
                tag: n[k] for tag, n in {**par_launches[0], **video_launches}.items() if n[k]}
    print(f"wall seconds by family: frame (phases 1-11, build included) {t_implicit - t_start:.1f}, "
          f"implicit (12-16) {t_video - t_implicit:.1f}, video (17-21) {t_graformer - t_video:.1f}, "
          f"GraFormer and probes (22-24) {t_parallel - t_graformer:.1f}, parallelism (25-27) "
          f"{t_video_parallel - t_parallel:.1f}, video parallelism and the dry run (28-31) "
          f"{t_tiers - t_video_parallel:.1f} (by phase {video_secs}), the tiers, the utilities "
          f"and the fast eval (32-35) {t_train_tiers - t_tiers:.1f}, the train kernels' tiers "
          f"(36-37) {t_end - t_train_tiers:.1f}")

    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
