"""The port's multi-rank dry run: every parallel path of the three families on
a world of ``n`` ranks, each held to its single-process reference.

Counterpart of ``__graft_entry__.py:dryrun_multichip``, which runs the JAX
package's sharded steps on an ``n``-device mesh and verifies the frame
family's.  Here the ranks are processes (``parallel/worker.py``), and every
path is checked against what one process computes from the same inputs
(``worker.frame_reference``, ``implicit_reference``, ``video_reference``):

* the frame family at full width (GCNDiff and GCNPose, hid 96, 5 layers) on
  a 1-D data mesh: the plain train step and the fused one with seeded
  dropout (the train kernels), a sweep of 2, the fused eval (the
  whole-network kernels) at 2 hypotheses, and on a ``(n // 2, 2)`` data x
  hypothesis grid the hypothesis-parallel eval;
* the implicit family (IGCN, damped, 4 iterations): the module train step
  and the fixed-count eval;
* the video family (SpatioTemporalDiff at its published width, 8-frame
  windows) on a ``(n // 2, 2)`` data x context mesh (``(n, 1)`` for odd n):
  the module train step (keys and values gathered, its dropout at 0) and
  the fused and module evals; on the 1-D data mesh the fused video train
  step, explicit masks and seeded dropout.

Sizes are the JAX dry run's: ``2n`` frames a frame step, ``2·data`` windows a
video step.  The last line printed is the JAX dry run's ``dryrun_multichip
OK (...)`` line with the same fields.

    python -m diffpose_tpu_torch.dryrun 4 --device cpu        # spawns 4 ranks (gloo)
    torchrun --nproc_per_node 4 -m diffpose_tpu_torch.dryrun 4   # inside the launcher's world
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

from diffpose_tpu_torch.data.synthetic import make_synthetic_dataset
from diffpose_tpu_torch.data.video import synthetic_video_dataset
from diffpose_tpu_torch.models import IGCN, GCNDiff, GCNPose
from diffpose_tpu_torch.models.video import SpatioTemporalDiff
from diffpose_tpu_torch.parallel import worker
from diffpose_tpu_torch.parallel.mesh import ENV_KEYS

TASKS = ("frame", "implicit", "video")
LOSS_REL = 1e-5                  # loss and gradient norm against the single-process step's
# every gradient entry: under GRAD_ABS, else under GRAD_REL of the model's
# largest gradient entry (tests/test_pallas_train.py:64-71 take each tensor's
# largest; at full width from a plain init some tensors' gradients are sums
# that cancel to ~1e-2, where the order of the ranks' sums moves them ~1e-5)
GRAD_ABS, GRAD_REL = 1e-5, 1e-3
PARAMS = 1e-4                    # parameters after the steps: Adam at lr 2e-5, eps 1e-8
EVAL = 2e-4                      # the eval pipeline's (tests/test_pallas_pipeline.py:53)
VIDEO_FRAMES = 8


def _state(model) -> dict:
    return {k: v.detach().cpu() for k, v in model.state_dict().items()}


def dryrun_spec(n: int, device: str = "cuda", backend: Optional[str] = None) -> dict:
    """The worker spec of the dry run over ``n`` ranks: seeded weights, the
    JAX dry run's batch sizes, every path of the module's docstring."""
    torch.manual_seed(0)
    basis = worker.BASIS
    diff, pose = GCNDiff(basis), GCNPose(basis)
    solver = dict(solver="damped", max_iterations=4, min_iterations=4)
    igcn = IGCN(basis, **solver)
    video = SpatioTemporalDiff(basis, VIDEO_FRAMES)
    b = 2 * n
    data = make_synthetic_dataset(num_frames=2 * b, n_kernels=3, seed=0)
    ev = make_synthetic_dataset(num_frames=b, n_kernels=3, seed=1)
    cp = 2 if n % 2 == 0 else 1
    windows = 2 * (n // cp)
    vdata = synthetic_video_dataset(2 * windows, VIDEO_FRAMES, seed=1)
    vev = synthetic_video_dataset(windows, VIDEO_FRAMES, seed=2)
    grid = dict(name="grid", sizes=(n // cp, cp), names=("data", "context"),
                train=[("module", "masks")], eval=["fused", "module"])
    return dict(
        device=device, backend=backend, cfg=dict(hid_dim=96, num_layers=5, num_heads=4),
        diff=_state(diff), pose=_state(pose), igcn=_state(igcn), igcn_solver=solver,
        batch=b, steps=1, lr=2e-5, eps=1e-8, seed=2,
        data={"poses_3d": data.poses_3d, "poses_2d_gmm": data.poses_2d_gmm},
        train_impls=[("plain", "masks"), ("fused", "prng")], sweep=2,
        sweep_idx=np.arange(2 * b).reshape(2, b) % len(data),
        eval=dict(batch={"poses_3d": ev.poses_3d, "poses_2d_gmm": ev.poses_2d_gmm,
                         "seeds": np.arange(b, dtype=np.int32)},
                  test_times=[2], hyp_test_times=[2], impl="fused", iterations=4),
        implicit=dict(implicit_impls=["module"], sweep=0,
                      eval=dict(batch={"poses_3d": ev.poses_3d, "poses_2d_gmm": ev.poses_2d_gmm,
                                       "seeds": np.arange(b, dtype=np.int32)},
                                test_times=[1], iterations=4, impl="fused")),
        video=dict(cfg=dict(frames=VIDEO_FRAMES), state=_state(video), batch=windows, steps=1,
                   data={"poses_3d": vdata.poses_3d, "poses_2d_gmm": vdata.poses_2d_gmm},
                   meshes=[grid, dict(name="data", sizes=(n,), names=("data",),
                                      train=[("fused", "masks"), ("fused", "prng")])],
                   eval=dict(batch={"poses_3d": vev.poses_3d, "poses_2d_gmm": vev.poses_2d_gmm,
                                    "seeds": np.arange(windows, dtype=np.int32)},
                             test_times=1)))


class _Held:
    """The checks that failed, and the worst relative gradient error seen."""

    def __init__(self):
        self.failures: List[str] = []
        self.worst = 0.0      # the worst gradient error relative to its model's largest entry

    def close(self, got, want, tol: float, what: str, rel: bool = False):
        got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
        err = float(np.abs(got - want).max()) if got.size else 0.0
        if rel:
            err /= max(float(np.abs(want).max()), 1e-30)
        if not (np.all(np.isfinite(got)) and err <= tol):
            self.failures.append(f"{what}: {'rel ' if rel else ''}max|Δ| {err:.3e} > {tol}")

    def steps(self, ranks, ref, tag: str, steps: int):
        """Train steps: loss, every gradient entry, the parameters; the
        ranks' parameters equal."""
        for s in range(steps):
            grads = [k for k in ref if k.startswith(f"{tag}/step{s}/grad/")]
            scale = max(float(np.abs(ref[k]).max()) for k in grads)
            for r, res in enumerate(ranks):
                for k in ("loss", "grad_norm"):
                    self.close(res[f"{tag}/step{s}/{k}"], ref[f"{tag}/step{s}/{k}"], LOSS_REL,
                               f"{tag} step {s} {k}, rank {r}", rel=True)
                for k in grads:
                    err = float(np.abs(res[k] - ref[k]).max())
                    self.worst = max(self.worst, err / scale)
                    if not err < GRAD_ABS and err / scale >= GRAD_REL:
                        self.failures.append(f"{k}, rank {r}: {err:.3e} of {scale:.3e}")
        for k in (k for k in ref if k.startswith(f"{tag}/params/")):
            self.close(ranks[0][k], ref[k], PARAMS, k)
            if not all(np.array_equal(res[k], ranks[0][k]) for res in ranks):
                self.failures.append(f"{k}: the ranks' parameters differ")


def check(spec: dict, ranks: List[Dict[str, np.ndarray]], device) -> str:
    """Hold the ranks' results to the single-process references; raise on a
    failure, else return the OK line."""
    n = len(ranks)
    ref = dict(worker.frame_reference(spec, ranks, device),
               **worker.implicit_reference(spec, ranks, device),
               **worker.video_reference(spec, ranks, device))
    held = _Held()
    for impl, dropout in spec["train_impls"]:
        held.steps(ranks, ref, f"frame/{impl}-{dropout}", spec["steps"])
    tag = "frame/sweep-{}-{}".format(*spec["train_impls"][0])
    for r, res in enumerate(ranks):
        held.close(res[f"{tag}/loss"], [ref[f"{tag}/step{s}/loss"] for s in range(spec["sweep"])],
                   LOSS_REL, f"{tag} losses, rank {r}", rel=True)
    for k in (k for k in ref if k.startswith(f"{tag}/params/")):
        held.close(ranks[0][k], ref[k], PARAMS, k)
    evals = [("frame/eval-data/tt2", None)]
    if n % 2 == 0:
        evals.append(("frame/eval-grid/tt2", list(range(0, n, 2))))
    evals.append(("implicit/eval/tt1", None))
    for tag, sel in evals:
        for key in ("p1", "p2", "pred"):
            held.close(worker.gathered(ranks, f"{tag}/{key}", sel), ref[f"{tag}/{key}"], EVAL,
                       f"{tag} {key}")
    held.steps(ranks, ref, "implicit/module", spec["steps"])
    v = spec["video"]
    for m in v["meshes"]:
        for impl, dropout in m.get("train", ()):
            part, _, _ = worker.video_part(ranks, m, impl, train=True)
            held.steps(part, ref, f"video/{m['name']}/train/{impl}-{dropout}", v["steps"])
        for impl in m.get("eval", ()):
            part, d, c = worker.video_part(ranks, m, impl, train=False)
            for key in ("p1", "p2", "pred"):
                tag = f"video/{m['name']}/eval/{impl}/{key}"
                held.close(worker.join_blocks([r[tag] for r in part], d, c), ref[tag], EVAL, tag)
    if held.failures:
        raise AssertionError("dryrun_multichip: sharded != single-process:\n  "
                             + "\n  ".join(held.failures))
    res = ranks[0]
    grid = v["meshes"][0]
    part, d, c = worker.video_part(ranks, grid, "fused", train=False)
    video_p1 = worker.join_blocks([r["video/grid/eval/fused/p1"] for r in part], d, c)

    def loss(tag):
        return float(res[f"{tag}/step0/loss"])

    return (f"dryrun_multichip OK (self-verified: sharded train ≡ single-process train on the "
            f"joined draws, sharded eval ≡ single-process eval, in every family): {n} devices, "
            f"train loss {loss('frame/plain-masks'):.3f}, "
            f"eval P1 {float(worker.gathered(ranks, 'frame/eval-data/tt2/p1').mean()) * 1000:.1f} mm, "
            f"fused-kernel train loss {loss('frame/fused-prng'):.3f}, "
            f"implicit loss {loss('implicit/module'):.3f}, "
            f"video loss {loss('video/grid/train/module-masks'):.3f}, "
            f"video fused-train loss {loss('video/data/train/fused-masks'):.3f}, "
            f"video P1 {float(video_p1.mean()) * 1000:.1f} mm "
            f"(video mesh {tuple(grid['sizes'])} data x context; worst gradient entry "
            f"{held.worst:.1e} of its model's largest)")


def _launched() -> bool:
    return any(k in os.environ for k in ENV_KEYS)


def dryrun_multichip(n_devices: int, *, device: str = "cuda", backend: Optional[str] = None,
                     timeout: float = 900.0) -> Optional[str]:
    """Run every parallel path on ``n_devices`` ranks and hold each to its
    single-process reference (the module's docstring); print and return the
    OK line, raise on any failure.

    Outside a launcher it spawns the ranks (``worker.spawn``), each on
    ``device`` (``"cuda"``: rank r on card r, nccl; ``"cuda:0"`` with
    ``backend="gloo"``: every rank on one card; ``"cpu"``: gloo).  Inside a
    ``torchrun`` world of ``n_devices`` ranks this process is one rank, and
    rank 0 checks and prints (the others return None).  Runs on the card
    unless ``device="cpu"`` is passed."""
    spec = dryrun_spec(n_devices, device, backend)
    ref_device = torch.device(device)
    if ref_device.type == "cuda":
        ref_device = torch.device("cuda", ref_device.index or 0)
    if _launched():
        return _in_world(spec, n_devices, ref_device)
    out = Path(tempfile.mkdtemp(prefix="dryrun_multichip_"))
    try:
        torch.save(spec, out / "spec.pth")
        argv = ["--spec", str(out / "spec.pth"), "--out", str(out)]
        for task in TASKS:
            argv += ["--task", task]
        worker.spawn(n_devices, argv, out / "logs", timeout=timeout,
                     env={"OMP_NUM_THREADS": "1"} if ref_device.type == "cpu" else None)
        line = check(spec, worker.load_ranks(out, n_devices), ref_device)
    finally:
        shutil.rmtree(out, ignore_errors=True)
    print(line)
    return line


def _in_world(spec: dict, n: int, ref_device) -> Optional[str]:
    import torch.distributed as dist

    from diffpose_tpu_torch.parallel.mesh import barrier, distributed_init, distributed_shutdown

    joined = not dist.is_initialized()
    rank, world = distributed_init(spec["backend"], device=spec["device"])
    try:
        if world != n:
            raise ValueError(f"dryrun_multichip({n}) inside a world of {world} ranks")
        out = [tempfile.mkdtemp(prefix="dryrun_multichip_") if rank == 0 else None]
        dist.broadcast_object_list(out, src=0)
        worker.run_tasks(spec, TASKS, out[0])
        barrier()
        line = None
        if rank == 0:
            try:
                line = check(spec, worker.load_ranks(out[0], n), torch.device(
                    "cuda", torch.cuda.current_device()) if ref_device.type == "cuda"
                    else ref_device)
            finally:
                shutil.rmtree(out[0], ignore_errors=True)
            print(line)
        barrier()
        return line
    finally:
        if joined:
            distributed_shutdown()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    parser.add_argument("n_devices", type=int)
    parser.add_argument("--device", default="cuda", help="cuda (the default), cuda:i or cpu")
    parser.add_argument("--backend", default=None, help="nccl or gloo (default: by device)")
    args = parser.parse_args(argv)
    dryrun_multichip(args.n_devices, device=args.device, backend=args.backend)
    return 0


if __name__ == "__main__":
    sys.exit(main())
