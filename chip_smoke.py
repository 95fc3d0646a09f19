#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's frame eval path on one GPU and check it.

Run from the root of a checkout, on a host with one NVIDIA H100:

    python3 chip_smoke.py

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
   (warmed up, median of several runs).

The line before the last holds the kernels' JSON record, the last line
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import functools
import json
import statistics
import subprocess
import sys
import time

import torch

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
from diffpose_tpu_torch.ops.fused_pipeline import lift_and_denoise, make_eval_fn

SEED = 0
BATCH = 1024
SEQ = (0, 12)
BETAS = get_beta_schedule("linear", beta_start=1e-4, beta_end=1e-3, num_diffusion_timesteps=51)
TEST_TIMES = (1, 5)
TOL_KERNEL = 5e-5     # tests/test_pallas_denoiser.py holds the TPU kernel to this
TOL_PIPELINE = 2e-4   # tests/test_pallas_pipeline.py
# H100 SXM peaks (NVIDIA data sheet): FP32 on CUDA cores, HBM3.
PEAK_FP32 = 67e12
PEAK_BYTES = 3.35e12


def check(ok: bool, msg: str):
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {msg}")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return float((a - b).abs().max())


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
