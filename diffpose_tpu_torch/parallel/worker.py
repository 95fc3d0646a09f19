"""Ranks of a ``torch.distributed`` world that run the sharded steps, and
their single-process references.

:func:`spawn` starts one process of this module a rank, with ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` set as
``torchrun`` sets them; a rank that fails (or a world that outlives its
time) ends every rank and raises.  Each rank reads a spec its caller wrote
with ``torch.save`` (weights, data, settings, read by :func:`frame_task`
and :func:`implicit_task`; the implicit task's own values of shared keys
may sit under ``implicit``), runs the tasks on its command
line and writes what it computed to ``<out>/rank<r>.npz``, flat keys such
as ``frame/fused-masks/step0/x_t``:

* ``frame``: ``make_mesh`` (a 1-D data mesh, a ``(world // 2, 2)`` data x
  hypothesis grid, the refused shape); ``make_sharded_train_step`` and
  ``make_sharded_train_sweep_step`` for each ``(impl, dropout)`` of the
  spec, with every step's draws, loss, gradients and the parameters at the
  end; ``make_sharded_eval_step`` at each ``test_times`` and, on the grid,
  with ``hyp_axis``; each kernel's launches on this rank;
* ``implicit``: ``make_sharded_implicit_train_step`` (its BatchNorm buffers
  and telemetry too), the warm-started sweep against as many single sharded
  steps, ``make_sharded_implicit_eval_step``;
* ``video`` (the spec's ``video``): for each mesh it names (a data, a
  context or a data x context grid), ``make_sharded_video_train_step`` for
  each ``(impl, dropout)`` (the module under the mesh's every axis, its
  dropout at 0; the fused and plain steps over the data axis alone) with
  every step's draws, loss, gradients and the parameters at the end;
  ``make_sharded_video_eval_step`` for each eval forward (``fused`` under
  every axis, ``fused_st`` and ``fused_full`` over data); the refusals of
  the whole-window paths under a context axis; ``make_cp_video_forward``
  on each context mesh; ``gather_frames`` through ``torch.autograd.gradcheck``;
  each kernel's launches on this rank;
* ``cli_frame`` / ``cli_implicit`` / ``cli_video``: the command lines with
  ``--data_parallel`` and ``--hypothesis_parallel 2`` (1 in a world of one),
  or the video family's ``--data_parallel`` / ``--context_parallel`` of the
  spec, inside this world (return codes, and the checkpoints each rank saved).

With ``time`` in the spec each sharded step is also timed against the
single-process step on the same draws (CUDA events).  The references take
the ranks' results: the frame family's single-process step on the
concatenated draws, its eval on the whole batch; the implicit family's
step as the mean of per-shard steps (BatchNorm normalises with each rank's
own batch statistics) and its eval on the whole batch; the video family's
single-process step on the ranks' draws joined along the windows and the
frames, and its eval on the whole batch (:func:`video_reference`).

    python -m diffpose_tpu_torch.parallel.worker --spec spec.pth --out DIR --task frame
"""

from __future__ import annotations

import argparse
import copy
import os
import socket
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from diffpose_tpu_torch.diffusion import get_beta_schedule
from diffpose_tpu_torch.graph import H36M_EDGES, cheb_basis_from_edges
from diffpose_tpu_torch.models import IGCN, GCNDiff, GCNPose
from diffpose_tpu_torch.ops import fused_denoiser as fd
from diffpose_tpu_torch.ops import fused_train as ft
from diffpose_tpu_torch.ops import fused_video_full as fv
from diffpose_tpu_torch.ops.fused_video_train import TemporalMasks, video_dropout_rates
from diffpose_tpu_torch.ops.philox import philox_masks
from diffpose_tpu_torch.ops.train_ref import DropoutMasks
from diffpose_tpu_torch.parallel.mesh import (
    distributed_init,
    distributed_shutdown,
    make_mesh,
    mesh_axis,
)
from diffpose_tpu_torch.models.video import SpatioTemporalDiff
from diffpose_tpu_torch.parallel.context import gather_frames, make_cp_video_forward
from diffpose_tpu_torch.parallel.sharding import (
    Shard,
    all_reduce_mean_grads,
    joint_axis,
    make_sharded_video_eval_step,
    make_sharded_video_train_step,
    shard_windows,
    make_sharded_eval_step,
    make_sharded_implicit_eval_step,
    make_sharded_implicit_train_step,
    make_sharded_implicit_train_sweep_step,
    make_sharded_train_step,
    make_sharded_train_sweep_step,
    max_over,
    shard_batch,
)
from diffpose_tpu_torch.train.implicit_steps import make_implicit_eval_step, make_implicit_train_step
from diffpose_tpu_torch.train.optim import make_optimizer
from diffpose_tpu_torch.train.state import TrainState
from diffpose_tpu_torch.train.steps import StepDraws, make_eval_step, make_train_step
from diffpose_tpu_torch.train.video_runner import video_denoise_override
from diffpose_tpu_torch.train.video_steps import (
    VideoDraws,
    make_video_eval_step,
    make_video_train_step,
)

BETAS = get_beta_schedule("linear", beta_start=1e-4, beta_end=1e-3, num_diffusion_timesteps=51)
SEQ = (0, 12)
BASIS = cheb_basis_from_edges(17, H36M_EDGES)
COUNTERS = {"lifter": fd.fused_lifter, "denoiser": fd.fused_denoiser,
            "backbone": fd.fused_backbone, "fwd": ft.stack_fwd, "bwd": ft.stack_bwd,
            "fwd_prng": ft.stack_fwd_prng, "bwd_prng": ft.stack_bwd_prng,
            "temporal": fv.fused_temporal_layer, "st": fv.fused_st_layer}


# ----------------------------------------------------------------------
# spawning a world
# ----------------------------------------------------------------------

def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(world: int, argv: Sequence[str], log_dir, *, timeout: float = 600.0,
          env: Optional[dict] = None) -> List[str]:
    """Run ``python -m diffpose_tpu_torch.parallel.worker *argv`` as ``world``
    ranks on this host, each rank's output to ``log_dir/rank<r>.log``;
    returns those outputs.  Raises, having ended every rank, if one fails
    or the world is not done within ``timeout`` seconds."""
    port = free_port()
    root = str(Path(__file__).resolve().parents[2])
    logs = Path(log_dir)
    logs.mkdir(parents=True, exist_ok=True)
    procs, files = [], []
    for rank in range(world):
        rank_env = {**os.environ, **(env or {}), "RANK": str(rank), "WORLD_SIZE": str(world),
                    "LOCAL_RANK": str(rank), "MASTER_ADDR": "127.0.0.1",
                    "MASTER_PORT": str(port),
                    "PYTHONPATH": os.pathsep.join(filter(None, [root, os.environ.get("PYTHONPATH")]))}
        f = open(logs / f"rank{rank}.log", "w+")
        files.append(f)
        procs.append(subprocess.Popen([sys.executable, "-m", "diffpose_tpu_torch.parallel.worker",
                                       *argv], env=rank_env, stdout=f, stderr=subprocess.STDOUT,
                                      cwd=root))
    deadline = time.monotonic() + timeout
    failed = None
    try:
        while any(p.poll() is None for p in procs):
            failed = next((r for r, p in enumerate(procs) if p.poll() not in (None, 0)), None)
            if failed is not None or time.monotonic() > deadline:
                break
            time.sleep(0.1)
        failed = next((r for r, p in enumerate(procs) if p.poll() not in (None, 0)), failed)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    outputs = []
    for f in files:
        f.seek(0)
        outputs.append(f.read())
        f.close()
    if failed is not None or any(p.returncode != 0 for p in procs):
        r = failed if failed is not None else 0
        raise RuntimeError(f"rank {r} of {world} failed (codes {[p.returncode for p in procs]}):\n"
                           + outputs[r][-6000:])
    return outputs


def load_ranks(out, world: int) -> List[Dict[str, np.ndarray]]:
    """Every rank's results as dicts of arrays."""
    ranks = []
    for r in range(world):
        with np.load(Path(out) / f"rank{r}.npz") as z:
            ranks.append({k: z[k] for k in z.files})
    return ranks


# ----------------------------------------------------------------------
# results as flat arrays
# ----------------------------------------------------------------------

def _np(v):
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


def _put_draws(res: dict, prefix: str, d: StepDraws):
    res[f"{prefix}/x_t"], res[f"{prefix}/t"], res[f"{prefix}/e"] = _np(d.x_t), _np(d.t), _np(d.e)
    if d.masks is not None:
        for k, v in d.masks._asdict().items():
            res[f"{prefix}/masks.{k}"] = _np(v)
    if d.seed is not None:
        res[f"{prefix}/seed"] = _np(d.seed)


def _put_params(res: dict, prefix: str, model: torch.nn.Module, grads: bool = False):
    for name, p in model.named_parameters():
        res[f"{prefix}/{name}"] = _np(p.grad if grads else p)


def _put_counts(res: dict, prefix: str):
    for name, fn in COUNTERS.items():
        res[f"{prefix}/{name}"] = np.asarray(fn.launches)


def _reset_counts():
    for fn in COUNTERS.values():
        fn.launches = 0


def draws_of(ranks: Sequence[dict], prefix: str, device, cfg: dict, float_masks: bool):
    """The ranks' draws under ``prefix`` as one global ``StepDraws``: rows
    concatenated in rank order; each rank's Philox seed becomes the masks it
    stands for, and of a single rank the seed is kept too (``float_masks``:
    masks as float32)."""
    dev = torch.device(device)
    seed = None

    def cat(key):
        return torch.as_tensor(np.concatenate([r[f"{prefix}/{key}"] for r in ranks]), device=dev)

    x_t, t, e = cat("x_t"), cat("t"), cat("e")
    if f"{prefix}/seed" in ranks[0]:
        parts = [philox_masks(torch.as_tensor(r[f"{prefix}/seed"], device=dev),
                              batch=r[f"{prefix}/x_t"].shape[0], device=dev, dtype=torch.float32,
                              **cfg) for r in ranks]
        masks = DropoutMasks(*(torch.cat(f, dim=1) for f in zip(*parts)))
        if len(ranks) == 1:
            seed = torch.as_tensor(ranks[0][f"{prefix}/seed"], device=dev)
    else:
        masks = DropoutMasks(*(torch.as_tensor(np.concatenate(
            [r[f"{prefix}/masks.{k}"] for r in ranks], axis=1), device=dev)
            for k in DropoutMasks._fields))
    if float_masks:
        masks = DropoutMasks(*(m.to(torch.float32) for m in masks))
    return StepDraws(x_t, t, e, masks, seed)


# ----------------------------------------------------------------------
# models and settings from the spec
# ----------------------------------------------------------------------

def _model(spec: dict, which: str, dev):
    cls = {"diff": GCNDiff, "pose": GCNPose, "igcn": IGCN}[which]
    kw = dict(spec["cfg"])
    if which == "pose":
        kw.update(coords_in=2, coords_out=3)
    if which == "igcn":
        kw.update(spec["igcn_solver"])
    model = cls(BASIS, **kw)
    model.load_state_dict(spec[which], strict=True)
    return model.to(dev)


def _train_state(model, spec: dict):
    opt = make_optimizer(model.parameters(), lr=spec["lr"], eps=spec["eps"])
    return TrainState.create(model, opt, None), opt


def _global_batch(spec: dict, i: int) -> dict:
    b = spec["batch"]
    return {k: v[i * b:(i + 1) * b] for k, v in spec["data"].items()}


def _time_pair(res: dict, tag: str, sharded, single, dev, collectives=None):
    """``sharded`` and ``single`` timed by turns, twice each (CUDA events,
    ``probes.time_ms``): ``ms_sharded`` and ``ms_single`` hold both runs;
    ``collectives``, the sharded step's collectives alone."""
    if dev.type != "cuda":
        return
    from diffpose_tpu_torch.probes import time_ms

    runs = {"sharded": [], "single": []}
    for _ in range(2):
        for name, fn in (("sharded", sharded), ("single", single)):
            runs[name].append(time_ms(fn, reps=3, runs=5))
    res[f"{tag}/ms_sharded"], res[f"{tag}/ms_single"] = (np.asarray(runs[k]) for k in runs)
    if collectives is not None:
        res[f"{tag}/ms_collectives"] = np.asarray(time_ms(collectives, reps=3, runs=5))


# ----------------------------------------------------------------------
# the tasks
# ----------------------------------------------------------------------

def frame_task(spec: dict, dev, res: dict):
    world = torch.distributed.get_world_size()
    mesh = make_mesh(device_type=dev.type)
    a = mesh_axis(mesh, "data")
    res["mesh/data"] = np.asarray([a.index, a.size])
    grid = None
    if world % 2 == 0:
        grid = make_mesh((world // 2, 2), ("data", "hypothesis"), device_type=dev.type)
        res["mesh/grid"] = np.asarray([mesh_axis(grid, n).index for n in ("data", "hypothesis")]
                                      + [mesh_axis(grid, n).size for n in ("data", "hypothesis")])
    try:
        make_mesh((world + 1,), device_type=dev.type)
    except AssertionError as e:
        res["mesh/refused"] = np.asarray(str(e))

    for impl, dropout in spec["train_impls"]:
        tag = f"frame/{impl}-{dropout}"
        model = _model(spec, "diff", dev)
        state, opt = _train_state(model, spec)
        step = make_sharded_train_step(model, opt, BETAS, mesh, impl=impl, dropout=dropout,
                                       device=dev)
        gen = torch.Generator(device=dev).manual_seed(spec["seed"])
        _reset_counts()
        for s in range(spec["steps"]):
            local = shard_batch(mesh, _global_batch(spec, s), device=dev)
            d = step.draw(local, gen)
            state, met = step.apply(state, d)
            _put_draws(res, f"{tag}/step{s}", d)
            res[f"{tag}/step{s}/loss"] = _np(met["loss"])
            res[f"{tag}/step{s}/grad_norm"] = _np(met["grad_norm"])
            _put_params(res, f"{tag}/step{s}/grad", model, grads=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        _put_counts(res, f"{tag}/launches")
        _put_params(res, f"{tag}/params", model)
        if spec.get("time"):
            single_model = _model(spec, "diff", dev)
            single_state, single_opt = _train_state(single_model, spec)
            single = make_train_step(single_model, single_opt, BETAS, impl=impl, dropout=dropout,
                                     device=dev)
            d0 = step.draw(shard_batch(mesh, _global_batch(spec, 0), device=dev), gen)
            _time_pair(res, tag, lambda: step.apply(state, d0),
                       lambda: single.apply(single_state, d0), dev,
                       lambda: all_reduce_mean_grads(model.parameters(), a, met["loss"]))

    if spec.get("sweep"):
        impl, dropout = spec["train_impls"][0]
        tag = f"frame/sweep-{impl}-{dropout}"
        model = _model(spec, "diff", dev)
        state, opt = _train_state(model, spec)
        base = make_sharded_train_step(model, opt, BETAS, mesh, impl=impl, dropout=dropout,
                                       device=dev)
        sweep = make_sharded_train_sweep_step(model, opt, BETAS, mesh, sweep=spec["sweep"],
                                              base_step=base)
        data = {k: torch.as_tensor(v, device=dev) for k, v in spec["data"].items()}
        idx = torch.as_tensor(spec["sweep_idx"], device=dev)
        state, met = sweep(state, data, idx, torch.Generator(device=dev).manual_seed(spec["seed"] + 1))
        res[f"{tag}/loss"] = _np(met["loss"])
        _put_params(res, f"{tag}/params", model)
        # the draws the sweep made: its step's draw replayed from the same generator
        gen = torch.Generator(device=dev).manual_seed(spec["seed"] + 1)
        cols = idx[:, shard_rows(mesh, idx.shape[1])]
        for s in range(spec["sweep"]):
            local = {k: v.index_select(0, cols[s]) for k, v in data.items()}
            _put_draws(res, f"{tag}/step{s}", base.draw(local, gen))

    ev = spec["eval"]
    diff, pose = _model(spec, "diff", dev).eval(), _model(spec, "pose", dev).eval()
    state = TrainState.create(diff, None)
    for mesh_, name, tts in ((mesh, "data", ev["test_times"]), (grid, "grid", ev["hyp_test_times"])):
        if mesh_ is None:
            continue
        local = shard_batch(mesh_, ev["batch"], device=dev)
        for tt in tts:
            tag = f"frame/eval-{name}/tt{tt}"
            step = make_sharded_eval_step(diff, pose, BETAS, SEQ, mesh_, test_times=tt,
                                          hyp_axis="hypothesis" if name == "grid" else None,
                                          impl=ev["impl"], device=dev)
            prepared = step.prepare(state, pose)
            _reset_counts()
            p1, p2, pred = step(state, pose, local, prepared=prepared)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            _put_counts(res, f"{tag}/launches")
            res[f"{tag}/p1"], res[f"{tag}/p2"], res[f"{tag}/pred"] = _np(p1), _np(p2), _np(pred)
            if spec.get("time") and name == "data":
                single = make_eval_step(diff, pose, BETAS, SEQ, test_times=tt, impl=ev["impl"],
                                        device=dev)
                _time_pair(res, tag, lambda: step(state, pose, local, prepared=prepared),
                           lambda: single(state, pose, local, prepared=prepared), dev)


def shard_rows(mesh, n: int) -> slice:
    from diffpose_tpu_torch.parallel.sharding import data_sharding

    return data_sharding(mesh).rows(n)


def implicit_task(spec: dict, dev, res: dict):
    spec = dict(spec, **spec.get("implicit", {}))
    mesh = make_mesh(device_type=dev.type)
    dropout = spec.get("implicit_dropout", "masks")
    for impl in spec["implicit_impls"]:
        tag = f"implicit/{impl}"
        model = _model(spec, "igcn", dev)
        state, opt = _train_state(model, spec)
        step = make_sharded_implicit_train_step(model, opt, BETAS, mesh, impl=impl,
                                                dropout=dropout, device=dev)
        gen = torch.Generator(device=dev).manual_seed(spec["seed"])
        _reset_counts()
        for s in range(spec["steps"]):
            local = shard_batch(mesh, _global_batch(spec, s), device=dev)
            d = step.draw(local, gen)
            state, met = step.apply(state, d)
            _put_draws(res, f"{tag}/step{s}", d)
            for k in ("loss", "grad_norm", "fp_iterations", "fp_residual"):
                res[f"{tag}/step{s}/{k}"] = _np(met[k])
            for k in ("running_mean", "running_var"):
                res[f"{tag}/step{s}/{k}"] = _np(getattr(model.batch_norm, k))
            _put_params(res, f"{tag}/step{s}/grad", model, grads=True)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        _put_counts(res, f"{tag}/launches")
        _put_params(res, f"{tag}/params", model)
        if spec.get("time"):
            single_model = _model(spec, "igcn", dev)
            single_state, single_opt = _train_state(single_model, spec)
            single = make_implicit_train_step(single_model, single_opt, BETAS, impl=impl,
                                              dropout=dropout, device=dev)
            d0 = step.draw(shard_batch(mesh, _global_batch(spec, 0), device=dev), gen)
            a = mesh_axis(mesh, "data")
            _time_pair(res, tag, lambda: step.apply(state, d0),
                       lambda: single.apply(single_state, d0), dev,
                       lambda: (all_reduce_mean_grads(
                                    model.parameters(), a, met["loss"], met["fp_iterations"],
                                    model.batch_norm.running_mean, model.batch_norm.running_var),
                                max_over(met["fp_residual"], a)))

    if spec.get("sweep"):
        # the warm-started sweep against as many single sharded steps with the carry
        impl, n, momentum = spec["implicit_impls"][0], spec["sweep"], 0.5
        data = {k: torch.as_tensor(v, device=dev) for k, v in spec["data"].items()}
        idx = torch.as_tensor(spec["sweep_idx"], device=dev)
        cols = idx[:, shard_rows(mesh, idx.shape[1])]
        b_local = cols.shape[1]
        for how in ("sweep", "steps"):
            model = _model(spec, "igcn", dev)
            state, opt = _train_state(model, spec)
            base = make_sharded_implicit_train_step(model, opt, BETAS, mesh, impl=impl,
                                                    dropout=dropout, device=dev,
                                                    use_warm_start=True)
            gen = torch.Generator(device=dev).manual_seed(spec["seed"] + 1)
            z0 = torch.zeros((b_local, 17, spec["cfg"]["hid_dim"]), device=dev)
            if how == "sweep":
                sweep = make_sharded_implicit_train_sweep_step(
                    model, opt, BETAS, mesh, sweep=n, use_warm_start=True,
                    warm_start_momentum=momentum, base_step=base)
                state, met = sweep(state, data, idx, gen, z0, 0.0)
                fp, losses = met["fixed_point"], met["loss"]
            else:
                w, losses = 0.0, []
                for s in range(n):
                    local = {k: v.index_select(0, cols[s]) for k, v in data.items()}
                    state, met = base(state, local, gen, z0, w)
                    z0, w = met["fixed_point"], momentum
                    losses.append(met["loss"])
                fp, losses = z0, torch.stack(losses)
            res[f"implicit/sweep/{how}/fixed_point"] = _np(fp)
            res[f"implicit/sweep/{how}/loss"] = _np(losses)
            _put_params(res, f"implicit/sweep/{how}/params", model)

    ev = spec["eval"]
    model, pose = _model(spec, "igcn", dev).eval(), _model(spec, "pose", dev).eval()
    model.solver = "damped"
    model.max_iterations = model.min_iterations = ev["iterations"]
    state = TrainState.create(model, None)
    local = shard_batch(mesh, ev["batch"], device=dev)
    for tt in ev["test_times"]:
        tag = f"implicit/eval/tt{tt}"
        step = make_sharded_implicit_eval_step(model, pose, mesh, t_infer=12, test_times=tt,
                                               impl=ev["impl"], device=dev)
        prepared = step.prepare(state, pose)
        _reset_counts()
        p1, p2, pred, iters = step(state, pose, local, prepared=prepared)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        _put_counts(res, f"{tag}/launches")
        res[f"{tag}/p1"], res[f"{tag}/p2"], res[f"{tag}/pred"] = _np(p1), _np(p2), _np(pred)
        res[f"{tag}/iters"] = _np(iters)
        if spec.get("time"):
            single = make_implicit_eval_step(model, pose, t_infer=12, test_times=tt,
                                             impl=ev["impl"], device=dev)
            _time_pair(res, tag, lambda: step(state, pose, local, prepared=prepared),
                       lambda: single(state, pose, local, prepared=prepared), dev)


# ----------------------------------------------------------------------
# the video family
# ----------------------------------------------------------------------

def _video_model(spec: dict, dev, cp_axis: Optional[str] = None, no_dropout: bool = False):
    """The spec's SpatioTemporalDiff (``video.cfg``, ``video.state``), built
    with ``cp_axis``; ``no_dropout``: every ``nn.Dropout`` at 0."""
    v = spec["video"]
    model = SpatioTemporalDiff(BASIS, **v["cfg"], cp_axis=cp_axis)
    model.load_state_dict(v["state"], strict=True)
    if no_dropout:
        for m in model.modules():
            if isinstance(m, torch.nn.Dropout):
                m.p = 0.0
    return model.to(dev)


def video_axes(names: Sequence[str], impl: str, train: bool):
    """The ``(data_axis, cp_axis)`` a video path (a train step with ``train``,
    else an eval) takes on a mesh with axes ``names``: the module train step
    and the ``fused`` / ``module`` evals every axis there is, the fused and
    plain train steps and the whole-window evals (``fused_st``,
    ``fused_full``) the data axis alone."""
    data = "data" if "data" in names else None
    whole = impl in (("fused", "plain") if train else ("fused_st", "fused_full"))
    return data, ("context" if "context" in names and not whole else None)


def _put_video_draws(res: dict, prefix: str, d: VideoDraws):
    res[f"{prefix}/x_t"], res[f"{prefix}/t"], res[f"{prefix}/e"] = _np(d.x_t), _np(d.t), _np(d.e)
    for name, group in (("masks", d.masks), ("tmasks", d.tmasks)):
        if group is not None:
            for k, v in group._asdict().items():
                res[f"{prefix}/{name}.{k}"] = _np(v)
    if d.seed is not None:
        res[f"{prefix}/seed"] = _np(d.seed)
    if d.drop_seed is not None:
        res[f"{prefix}/drop_seed"] = np.asarray(d.drop_seed, dtype=np.uint64)


def video_task(spec: dict, dev, res: dict):
    v = spec["video"]
    frames = v["cfg"]["frames"]
    for m in v["meshes"]:
        name, names = m["name"], tuple(m["names"])
        mesh = make_mesh(m["sizes"], names, device_type=dev.type)
        cp = mesh_axis(mesh, "context")
        res[f"video/{name}/coords"] = np.asarray([mesh_axis(mesh, n).index for n in names])

        for impl, dropout in m.get("train", ()):
            tag = f"video/{name}/train/{impl}-{dropout}"
            data_axis, cp_axis = video_axes(names, impl, train=True)
            model = _video_model(spec, dev, cp_axis, no_dropout=impl == "module")
            state, opt = _train_state(model, spec)
            step = make_sharded_video_train_step(model, opt, BETAS, mesh, data_axis=data_axis,
                                                 cp_axis=cp_axis, impl=impl, dropout=dropout,
                                                 device=dev)
            gen = torch.Generator(device=dev).manual_seed(spec["seed"])
            _reset_counts()
            for s in range(v["steps"]):
                local = shard_windows(mesh, _video_batch(v, s), data_axis, cp_axis, device=dev)
                d = step.draw(local, gen)
                state, met = step.apply(state, d)
                _put_video_draws(res, f"{tag}/step{s}", d)
                res[f"{tag}/step{s}/loss"] = _np(met["loss"])
                res[f"{tag}/step{s}/grad_norm"] = _np(met["grad_norm"])
                _put_params(res, f"{tag}/step{s}/grad", model, grads=True)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            _put_counts(res, f"{tag}/launches")
            _put_params(res, f"{tag}/params", model)
            if spec.get("time"):
                single_model = _video_model(spec, dev, no_dropout=impl == "module")
                single_state, single_opt = _train_state(single_model, spec)
                single = make_video_train_step(single_model, single_opt, BETAS, impl=impl,
                                               dropout=dropout, device=dev)
                d0 = step.draw(shard_windows(mesh, _video_batch(v, 0), data_axis, cp_axis,
                                             device=dev), gen)
                both = joint_axis(mesh_axis(mesh, data_axis) if data_axis else None,
                                  cp if cp_axis else None)
                data_size = mesh_axis(mesh, data_axis).size if data_axis else 1
                _time_pair(res, tag, lambda: step.apply(state, d0),
                           lambda: single.apply(single_state, d0), dev,
                           lambda: all_reduce_mean_grads(model.parameters(), both, met["loss"],
                                                         divisor=data_size))

        ev = v["eval"]
        for impl in m.get("eval", ()):
            tag = f"video/{name}/eval/{impl}"
            data_axis, cp_axis = video_axes(names, impl, train=False)
            model = _video_model(spec, dev, cp_axis).eval()
            state = TrainState.create(model, None)
            step = make_sharded_video_eval_step(
                model, BETAS, SEQ, mesh, frames_total=frames, data_axis=data_axis,
                cp_axis=cp_axis, test_times=ev["test_times"],
                denoise_override=video_denoise_override(model, impl), device=dev)
            local = shard_windows(mesh, ev["batch"], data_axis, cp_axis, device=dev)
            prepared = step.prepare(state)
            _reset_counts()
            p1, p2, pred = step(state, local, prepared=prepared)
            if dev.type == "cuda":
                torch.cuda.synchronize()
            _put_counts(res, f"{tag}/launches")
            res[f"{tag}/p1"], res[f"{tag}/p2"], res[f"{tag}/pred"] = _np(p1), _np(p2), _np(pred)
            if spec.get("time"):
                single_model = _video_model(spec, dev).eval()
                single_state = TrainState.create(single_model, None)
                single = make_video_eval_step(
                    single_model, BETAS, SEQ, test_times=ev["test_times"], device=dev,
                    denoise_override=video_denoise_override(single_model, impl))
                single_prepared = single.prepare(single_state)
                collectives = None
                if cp_axis is not None:
                    # the step's collectives alone: K|V of every layer at every DDIM step
                    rows = ev["test_times"] * local["poses_3d"].shape[0] * 17
                    kv = torch.zeros((rows, frames // cp.size, 2 * model.hid_dim), device=dev)

                    def collectives():
                        for _ in range(model.num_layers * len(SEQ)):
                            gather_frames(kv, cp)

                _time_pair(res, tag, lambda: step(state, local, prepared=prepared),
                           lambda: single(single_state, local, prepared=single_prepared), dev,
                           collectives)

        if cp.size > 1:
            _video_context_checks(spec, dev, res, mesh, name, cp)


def _video_batch(v: dict, i: int) -> dict:
    b = v["batch"]
    return {k: a[i * b:(i + 1) * b] for k, a in v["data"].items()}


def _video_context_checks(spec: dict, dev, res: dict, mesh, name: str, cp):
    """On a context mesh: the refusals of the whole-window paths, the context
    forward of the spec's ``forward`` input, and ``gather_frames`` through
    ``gradcheck`` in float64 from one rank's view."""
    v = spec["video"]
    refused = []
    try:
        model = _video_model(spec, dev, "context")
        _, opt = _train_state(model, spec)
        make_sharded_video_train_step(model, opt, BETAS, mesh, cp_axis="context", impl="fused",
                                      device=dev)
    except ValueError as e:
        refused.append(str(e))
    model = _video_model(spec, dev, "context").eval().bind_mesh(mesh)
    x = torch.zeros((1, v["cfg"]["frames"] // cp.size, 17, 5), device=dev)
    for impl in ("fused_st", "fused_full"):
        try:
            video_denoise_override(model, impl)(fv.prepare_video_weights(model, dev), x,
                                                torch.zeros(1, device=dev))
        except ValueError as e:
            refused.append(str(e))
    res[f"video/{name}/refused"] = np.asarray(refused)
    if "forward" in v:
        model = _video_model(spec, dev, "context").eval()
        fn = make_cp_video_forward(model, mesh)
        x, t = (torch.as_tensor(a, device=dev) for a in (v["forward"]["x"], v["forward"]["t"]))
        with torch.no_grad():
            res[f"video/{name}/forward"] = _np(fn(x[:, model.frame_block(x.shape[1] // cp.size)], t))
    if v.get("gradcheck"):
        view = cp.size - 1          # the rank whose input and output count; the rest send zeros
        gen = torch.Generator().manual_seed(cp.index)
        x = torch.randn((2, 2, 3), generator=gen, dtype=torch.float64).to(dev).requires_grad_()

        def fn(y):
            if cp.index == view:
                return gather_frames(y, cp)
            return gather_frames(y * 0 + 1, cp) * 0

        res[f"video/{name}/gradcheck"] = np.asarray(torch.autograd.gradcheck(fn, (x,)))


def _hyp_ranks() -> str:
    """The ``--hypothesis_parallel`` a world of this size takes: 2, or 1 alone."""
    return "2" if torch.distributed.get_world_size() % 2 == 0 else "1"


def _cli_runs(spec: dict, runs, res: dict, family: str):
    """Each command line in this world; its return code and the checkpoints
    this rank saved."""
    from diffpose_tpu_torch.train.checkpoint import Checkpointer

    saves = {"n": 0}
    save = Checkpointer.save

    def counted(self, *args, **kwargs):
        saves["n"] += 1
        return save(self, *args, **kwargs)

    Checkpointer.save = counted
    try:
        for name, main, argv in runs:
            saves["n"] = 0
            res[f"{family}/{name}/rc"] = np.asarray(main(argv))
            res[f"{family}/{name}/saves"] = np.asarray(saves["n"])
            torch.distributed.barrier()
    finally:
        Checkpointer.save = save


def cli_frame_task(spec: dict, dev, res: dict):
    from diffpose_tpu_torch.cli import main_frame

    exp, device = spec["exp"], str(dev)
    common = ["--config", "configs/human36m_diffpose_uvxyz_gt.yml", "--exp", exp, "--ni",
              "--synthetic_frames", "32", "--batch_size", "16", "--device", device,
              "--denoiser_impl", "fused"]
    train = common + ["--doc", "dp", "--train", "--train_impl", "fused", "--dropout_impl",
                      "prng", "--data_parallel"]
    ckpt = str(Path(exp) / "dp" / "ckpt_00000004")
    _cli_runs(spec, [
        ("train", main_frame.main, train + ["--n_epochs", "1"]),
        ("resume", main_frame.main, train + ["--n_epochs", "2", "--resume"]),
        ("hyp_eval", main_frame.main, common + [
            "--doc", "hp", "--hypothesis_parallel", _hyp_ranks(), "--test_times", "2",
            "--model_diff_path", ckpt + ".pth", "--model_pose_path", ckpt + ".pose.pth"]),
    ], res, "cli_frame")


def cli_implicit_task(spec: dict, dev, res: dict):
    from diffpose_tpu_torch.cli import compare, main_implicit

    exp, device = spec["exp"], str(dev)
    common = ["--config", "configs/human36m_ipose.yml", "--exp", exp, "--ni",
              "--synthetic_frames", "32", "--batch_size", "16", "--device", device,
              "--implicit_iters", "3", "--min_iterations", "2", "--denoiser_impl", "fused"]
    _cli_runs(spec, [
        ("train", main_implicit.main, common + [
            "--doc", "ip", "--train", "--use_implicit", "--n_epochs", "1", "--train_impl",
            "fused", "--dropout_impl", "prng", "--data_parallel"]),
        ("hyp_eval", main_implicit.main, common + [
            "--doc", "ih", "--use_implicit", "--hypothesis_parallel", _hyp_ranks(),
            "--test_times", "2",
            "--model_diff_path", str(Path(exp) / "ip" / "ckpt_00000002.pth")]),
        ("compare", compare.main, ["--config", "configs/human36m_ipose.yml", "--exp", exp,
                                   "--doc", "cmp", "--ni", "--synthetic_frames", "16",
                                   "--batch_size", "16", "--device", device,
                                   "--denoiser_impl", "fused", "--data_parallel"]),
    ], res, "cli_implicit")


def cli_video_task(spec: dict, dev, res: dict):
    from diffpose_tpu_torch.cli import main_video

    c, exp = spec["video"]["cli"], spec["exp"]
    common = ["--config", "configs/human36m_video.yml", "--exp", exp, "--ni",
              "--frames", str(c["frames"]), "--synthetic_windows", str(c["windows"]),
              "--batch_size", str(c["batch"]), "--device", str(dev), *c["flags"]]
    _cli_runs(spec, [
        ("train", main_video.main, common + ["--doc", "vp", "--train", "--n_epochs", "1",
                                             "--denoiser_impl", "fused"]),
        ("eval", main_video.main, common + [
            "--doc", "ve", "--denoiser_impl", "fused", "--model_diff_path",
            str(Path(exp) / "vp" / f"ckpt_{-(-c['windows'] // c['batch']):08d}.pth")]),
    ], res, "cli_video")


TASKS = {"frame": frame_task, "implicit": implicit_task, "video": video_task,
         "cli_frame": cli_frame_task, "cli_implicit": cli_implicit_task,
         "cli_video": cli_video_task}


# ----------------------------------------------------------------------
# single-process references
# ----------------------------------------------------------------------

def _ranks_cfg(spec):
    return {k: spec["cfg"][k] for k in ("num_layers", "num_heads", "hid_dim")}


def frame_reference(spec: dict, ranks: Sequence[dict], device) -> dict:
    """The single-process results the frame task's ranks should give: each
    train step on the concatenated draws (a Philox seed's draws through the
    plain stack over that seed's masks), the sweep likewise over its
    replayed draws, each eval on the whole batch."""
    dev = torch.device(device)
    ref = {}

    def train(tag, impl, dropout, n):
        model = _model(spec, "diff", dev)
        state, opt = _train_state(model, spec)
        # a world of ranks' seeds stands as their masks, through the plain stack
        ref_impl, ref_dropout = ("plain", "masks") if dropout == "prng" and len(ranks) > 1 \
            else (impl, dropout)
        step = make_train_step(model, opt, BETAS, impl=ref_impl, dropout=ref_dropout, device=dev)
        for s in range(n):
            d = draws_of(ranks, f"{tag}/step{s}", dev, _ranks_cfg(spec),
                         float_masks=ref_impl == "plain")
            state, met = step.apply(state, d)
            ref[f"{tag}/step{s}/loss"] = _np(met["loss"])
            ref[f"{tag}/step{s}/grad_norm"] = _np(met["grad_norm"])
            _put_params(ref, f"{tag}/step{s}/grad", model, grads=True)
        _put_params(ref, f"{tag}/params", model)

    for impl, dropout in spec["train_impls"]:
        train(f"frame/{impl}-{dropout}", impl, dropout, spec["steps"])
    if spec.get("sweep"):
        impl, dropout = spec["train_impls"][0]
        train(f"frame/sweep-{impl}-{dropout}", impl, dropout, spec["sweep"])
    ev = spec["eval"]
    diff, pose = _model(spec, "diff", dev).eval(), _model(spec, "pose", dev).eval()
    state = TrainState.create(diff, None)
    for name, tts, parts, hyp in (("data", ev["test_times"], len(ranks), 1),
                                  ("grid", ev["hyp_test_times"], max(len(ranks) // 2, 1), 2)):
        for tt in tts:
            whole, shard = (make_eval_step(diff, pose, BETAS, SEQ, test_times=n, impl=ev["impl"],
                                           device=dev) for n in (tt, tt // hyp))
            _eval_refs(ref, f"frame/eval-{name}/tt{tt}", ev["batch"], parts, dev,
                       lambda b: whole(state, pose, b), lambda b: shard(state, pose, b))
    return ref


def _eval_refs(ref: dict, tag: str, batch: dict, parts: int, dev, step, shard_step=None):
    """``step`` on the whole batch (``p1``, ``p2``, ``pred``, ``iters``) and
    ``shard_step`` (default ``step``) on each of its ``parts`` data shards
    alone, concatenated (``p1_shards``...): a rank's own computation, at its
    batch size and with its share of the hypotheses, whose mean over
    identical hypotheses is exact."""
    whole = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
    shard_step = shard_step or step
    for suffix, outs in (("", [step(whole)]),
                         ("_shards", [shard_step({k: v[Shard(i, parts).rows(v.shape[0])]
                                                  for k, v in whole.items()})
                                      for i in range(parts)])):
        for key, vals in zip(("p1", "p2", "pred", "iters"), zip(*outs)):
            ref[f"{tag}/{key}{suffix}"] = np.concatenate([np.atleast_1d(_np(v)) for v in vals])


def implicit_reference(spec: dict, ranks: Sequence[dict], device) -> dict:
    """The implicit task's single-process counterparts: each train step as
    the mean of per-shard steps (every shard's gradient and BatchNorm
    buffers from the same parameters, averaged, then one update); the eval
    on the whole batch."""
    from diffpose_tpu_torch.ops.fused_igcn_train import make_igcn_train_fn
    from diffpose_tpu_torch.train.steps import diffusion_loss

    spec = dict(spec, **spec.get("implicit", {}))
    dev = torch.device(device)
    ref = {}
    names = ("running_mean", "running_var")
    dropout = spec.get("implicit_dropout", "masks")
    for impl in spec["implicit_impls"]:
        tag = f"implicit/{impl}"
        model = _model(spec, "igcn", dev).train()
        _, opt = _train_state(model, spec)
        for s in range(spec["steps"]):
            grads, bns, losses = [], [], []
            for r in range(len(ranks)):
                m = copy.deepcopy(model)
                d = draws_of(ranks[r:r + 1], f"{tag}/step{s}", dev, _ranks_cfg(spec),
                             float_masks=impl != "fused")
                t = d.t.to(torch.float32)
                if impl == "fused":
                    drop = d.seed if dropout == "prng" else d.masks
                    out, _, running = make_igcn_train_fn(m, dropout=dropout)(d.x_t, t, drop)
                else:
                    out, _ = m(d.x_t, t, masks=d.masks)
                    running = {k: getattr(m.batch_norm, k) for k in names}
                loss = diffusion_loss(out, d.e)
                grads.append(torch.autograd.grad(loss, list(m.parameters())))
                bns.append({k: running[k].detach() for k in names})
                losses.append(loss.detach())
            with torch.no_grad():
                for k in names:
                    getattr(model.batch_norm, k).copy_(torch.stack([b[k] for b in bns]).mean(0))
            for p, *g in zip(model.parameters(), *grads):
                p.grad = torch.stack(g).mean(0)
            grad_norm = opt.step()
            ref[f"{tag}/step{s}/loss"] = _np(torch.stack(losses).mean())
            ref[f"{tag}/step{s}/grad_norm"] = _np(grad_norm)
            for k in names:
                ref[f"{tag}/step{s}/{k}"] = _np(getattr(model.batch_norm, k))
            _put_params(ref, f"{tag}/step{s}/grad", model, grads=True)
        _put_params(ref, f"{tag}/params", model)
    ev = spec["eval"]
    model, pose = _model(spec, "igcn", dev).eval(), _model(spec, "pose", dev).eval()
    model.solver = "damped"
    model.max_iterations = model.min_iterations = ev["iterations"]
    state = TrainState.create(model, None)
    for tt in ev["test_times"]:
        step = make_implicit_eval_step(model, pose, t_infer=12, test_times=tt, impl=ev["impl"],
                                       device=dev)
        _eval_refs(ref, f"implicit/eval/tt{tt}", ev["batch"], len(ranks), dev,
                   lambda b: step(state, pose, b))
    return ref


def video_part(ranks: Sequence[dict], m: dict, impl: str, train: bool):
    """The ranks whose blocks make up a video path's global result on mesh
    spec ``m``, and how they lie: ``(part, D, C)``, ``part[i·C + j]`` holding
    windows block ``i`` and frames block ``j``.  A path that keeps whole
    windows on a mesh with a context axis (the fused train step, the
    whole-window evals) runs alike on every context coordinate: one rank of
    each data coordinate stands for them."""
    names, sizes = tuple(m["names"]), tuple(m["sizes"])
    d = sizes[names.index("data")] if "data" in names else 1
    c = sizes[names.index("context")] if "context" in names else 1
    if video_axes(names, impl, train)[1] is None:
        return [ranks[i * c] for i in range(d)], d, 1
    return list(ranks), d, c


def join_blocks(blocks: Sequence[np.ndarray], d: int, c: int, frame_axis: int = 1,
                row_axis: int = 0) -> np.ndarray:
    """``D·C`` blocks (``blocks[i·C + j]``) joined into the global array: each
    data coordinate's along ``frame_axis``, then those along ``row_axis``."""
    rows = [np.concatenate(blocks[i * c:(i + 1) * c], axis=frame_axis) for i in range(d)]
    return np.concatenate(rows, axis=row_axis)


def video_reference(spec: dict, ranks: Sequence[dict], device) -> dict:
    """The single-process results the video task's ranks should give: each
    train step on the ranks' draws joined along the windows and the frames
    (the fused step's Philox seeds, of a world of ranks, as their masks
    through the plain stack; the module at dropout 0), under the ranks'
    keys; each eval on the whole batch, ``[B, F]`` errors, and where the
    windows alone are split, on each data shard alone (``..._shards``)."""
    dev = torch.device(device)
    v = spec["video"]
    ref = {}
    for m in v["meshes"]:
        name = m["name"]
        for impl, dropout in m.get("train", ()):
            tag = f"video/{name}/train/{impl}-{dropout}"
            part, d, c = video_part(ranks, m, impl, train=True)
            model = _video_model(spec, dev, no_dropout=impl == "module")
            state, opt = _train_state(model, spec)
            ref_impl, ref_dropout = (("plain", "masks") if dropout == "prng" and len(part) > 1
                                     else (impl, dropout))
            step = make_video_train_step(model, opt, BETAS, impl=ref_impl, dropout=ref_dropout,
                                         device=dev)
            for s in range(v["steps"]):
                p = f"{tag}/step{s}"

                def cat(key, frame_axis=1, row_axis=0):
                    return torch.as_tensor(join_blocks([r[f"{p}/{key}"] for r in part], d, c,
                                                       frame_axis, row_axis), device=dev)

                t = torch.as_tensor(np.concatenate([part[i * c][f"{p}/t"] for i in range(d)]),
                                    device=dev)
                masks = seed = tmasks = None
                if dropout == "prng" and len(part) > 1:
                    masks = _seed_masks(part, p, model, dev)
                elif dropout == "prng":
                    seed = torch.as_tensor(part[0][f"{p}/seed"], device=dev)
                elif impl != "module":       # batch-major rows [L, rows, ...]: whole windows
                    masks = DropoutMasks(*(cat(f"masks.{k}", 1, 1) for k in DropoutMasks._fields))
                    if ref_impl == "plain":
                        masks = DropoutMasks(*(mk.to(torch.float32) for mk in masks))
                if f"{p}/tmasks.probs" in part[0]:
                    tmasks = TemporalMasks(*(cat(f"tmasks.{k}", 1, 1)
                                             for k in TemporalMasks._fields))
                _, met = step.apply(state, VideoDraws(cat("x_t"), t, cat("e"), masks, seed, tmasks))
                ref[f"{p}/loss"] = _np(met["loss"])
                ref[f"{p}/grad_norm"] = _np(met["grad_norm"])
                _put_params(ref, f"{p}/grad", model, grads=True)
            _put_params(ref, f"{tag}/params", model)
        ev = v["eval"]
        whole = {k: torch.as_tensor(a, device=dev) for k, a in ev["batch"].items()}
        for impl in m.get("eval", ()):
            model = _video_model(spec, dev).eval()
            step = make_video_eval_step(model, BETAS, SEQ, test_times=ev["test_times"], device=dev,
                                        denoise_override=video_denoise_override(model, impl))
            state = TrainState.create(model, None)
            _, d, c = video_part(ranks, m, impl, train=False)
            outs = {"": [step(state, whole)]}
            if c == 1 and d > 1:     # each data shard alone: a rank's own computation
                outs["_shards"] = [step(state, {k: a[Shard(i, d).rows(a.shape[0])]
                                                for k, a in whole.items()}) for i in range(d)]
            for suffix, parts in outs.items():
                for key, vals in zip(("p1", "p2", "pred"), zip(*parts)):
                    ref[f"video/{name}/eval/{impl}/{key}{suffix}"] = np.concatenate(
                        [_np(v) for v in vals])
    return ref


def _seed_masks(part, p, model, dev) -> DropoutMasks:
    """The explicit masks the ranks' Philox seeds stand for, at each rank's
    ``B·F`` rows, joined: layer ``i`` of the video stack draws from ``seed +
    i·1000003`` (``ops/fused_video_train.py:layer_seed``)."""
    from diffpose_tpu_torch.ops.fused_video_train import layer_seed

    per_rank = []
    for r in part:
        seed = torch.as_tensor(r[f"{p}/seed"], device=dev)
        rows = r[f"{p}/x_t"].shape[0] * r[f"{p}/x_t"].shape[1]
        layers = [philox_masks(layer_seed(seed, i), num_layers=1, batch=rows, n_pts=17,
                               num_heads=model.num_heads, hid_dim=model.hid_dim,
                               rates=video_dropout_rates(model), device=dev, dtype=torch.float32)
                  for i in range(model.num_layers)]
        per_rank.append(DropoutMasks(*(torch.cat(f, dim=0) for f in zip(*layers))))
    return DropoutMasks(*(torch.cat(f, dim=1) for f in zip(*per_rank)))


def gathered(ranks: Sequence[dict], key: str, data_ranks: Optional[Sequence[int]] = None):
    """A per-sample result of the data ranks (all by default) in the global
    batch's order."""
    sel = ranks if data_ranks is None else [ranks[r] for r in data_ranks]
    return np.concatenate([r[key] for r in sel])


# ----------------------------------------------------------------------

def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("--spec", required=True, help="torch.save'd dict of the tasks' inputs")
    parser.add_argument("--out", required=True, help="directory for rank<r>.npz")
    parser.add_argument("--task", action="append", choices=sorted(TASKS), required=True)
    args = parser.parse_args(argv)
    spec = torch.load(args.spec, weights_only=False)
    try:
        run_tasks(spec, args.task, args.out)
    finally:
        distributed_shutdown()
    return 0


def run_tasks(spec: dict, tasks: Sequence[str], out) -> int:
    """This rank's part: join the world (``distributed_init`` over the spec's
    device and backend), run ``tasks`` and write ``out/rank<r>.npz``;
    returns the rank."""
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(spec.get("threads", torch.get_num_threads()))
    rank, _ = distributed_init(spec.get("backend"), device=dev)
    res: dict = {}
    for task in tasks:
        TASKS[task](spec, dev, res)
    np.savez(Path(out) / f"rank{rank}.npz", **res)
    return rank


if __name__ == "__main__":
    sys.exit(main())
