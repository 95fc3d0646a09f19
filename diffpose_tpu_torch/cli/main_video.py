"""Video-family CLI: train and evaluate the spatio-temporal diffusion model
(counterpart of ``diffpose_tpu/cli/main_video.py``).  Runs on ``--device
cuda`` unless told ``--device cpu``.

The frame CLI's flags, plus ``--frames`` (window length) and
``--synthetic_windows``.  ``--data_parallel`` shards the windows over every
rank of the job, ``--context_parallel N`` each window's frames over N ranks,
and both together give a ``(world // N, N)`` data x context mesh (one
process a rank, launched as the frame CLI's mesh flags are: ``torchrun``,
nccl over ``--device cuda``, gloo over ``--device cpu``; without a launcher a
world of one rank).  ``--hypothesis_parallel`` has no video counterpart (the
JAX CLI ignores it) and is refused.  ``--model_diff_path`` loads a checkpoint
``.pth`` of this CLI for an eval-only run.

Train, resume, eval-only (no dataset files needed):
    python -m diffpose_tpu_torch.cli.main_video --config configs/human36m_video.yml \\
        --doc run1 --train --ni --synthetic_windows 128 \\
        --train_impl fused --dropout_impl prng --denoiser_impl fused_full
    ... the same with --resume --n_epochs N
    python -m diffpose_tpu_torch.cli.main_video --config configs/human36m_video.yml \\
        --doc eval1 --ni --synthetic_windows 128 --denoiser_impl fused_st \\
        --model_diff_path exp/run1/ckpt_<step>.pth
Data x context parallel over four GPUs (2 x 2; the module train step, the
fused eval forward):
    torchrun --nproc_per_node 4 -m diffpose_tpu_torch.cli.main_video \
        --config configs/human36m_video.yml --doc run2 --train --ni --synthetic_windows 128 \
        --data_parallel --context_parallel 2 --denoiser_impl fused
"""

from __future__ import annotations

import argparse
import contextlib
import logging
import sys
import traceback

import torch

from diffpose_tpu_torch.cli.common import (
    add_common_flags,
    resolve_impl,
    setup_experiment,
)
from diffpose_tpu_torch.parallel.mesh import barrier


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_flags(parser)
    parser.add_argument("--frames", type=int, default=None,
                        help="override video.frames (window length, e.g. 81/243)")
    parser.add_argument("--context_parallel", type=int, default=0, metavar="N",
                        help="shard the frame axis over N ranks (a context mesh axis; the "
                        "world must be N ranks, or divide by N with --data_parallel for a "
                        "(world // N, N) data x context mesh)")
    parser.add_argument("--synthetic_windows", default=0, type=int,
                        help="use a synthetic dataset of N windows (smoke runs)")
    return parser.parse_args(argv)


@contextlib.contextmanager
def video_mesh(args):
    """The mesh the flags ask for (``diffpose_tpu/cli/main_video.py:32-47``),
    or None, for the body of a ``with``: ``--data_parallel`` a 1-D data mesh
    over the world, ``--context_parallel N`` a 1-D context mesh of N ranks (the
    world), both a ``(world // N, N)`` data x context grid.  Joins the
    process group first (``parallel.distributed_init``); a group joined here
    is left again when the ``with`` ends."""
    if args.hypothesis_parallel:
        raise ValueError("--hypothesis_parallel: the video family has no hypothesis axis "
                         "(its JAX CLI ignores the flag); use --data_parallel and "
                         "--context_parallel")
    cp = args.context_parallel
    if not args.data_parallel and cp <= 0:
        yield None
        return
    import torch.distributed as dist

    from diffpose_tpu_torch.parallel.mesh import distributed_init, distributed_shutdown, make_mesh

    joined = not dist.is_initialized()
    _, world = distributed_init(device=args.device)
    device_type = torch.device(args.device).type
    try:
        if args.data_parallel and cp > 0:
            if world % cp:
                raise ValueError(f"{world} ranks not divisible by context_parallel={cp}")
            yield make_mesh((world // cp, cp), ("data", "context"), device_type=device_type)
        elif args.data_parallel:
            yield make_mesh(device_type=device_type)
        else:
            if world != cp:
                raise ValueError(f"--context_parallel {cp} alone takes a world of {cp} ranks, "
                                 f"not {world} (add --data_parallel for a data x context grid)")
            yield make_mesh((cp,), ("context",), device_type=device_type)
    finally:
        if joined:
            distributed_shutdown()


def main(argv=None) -> int:
    args = parse_args(argv)
    with video_mesh(args) as mesh:     # before the log dir: only rank 0 writes it
        return _run(args, mesh)


def _run(args, mesh) -> int:
    config = setup_experiment(args)
    barrier()   # every rank sees the log dir rank 0 made

    from diffpose_tpu_torch.config import VideoConfig
    from diffpose_tpu_torch.train.video_runner import VideoRunner

    if config.video is None:
        config.video = VideoConfig()
    if args.frames is not None:
        config.video.frames = args.frames
    # The sweep knobs belong to the frame runner; say so instead of silently
    # accepting them from the shared flag set.
    for flag, default in (("eval_sweep", 1), ("train_sweep", 1)):
        if getattr(args, flag) != default:
            logging.warning("--%s is not supported by the video runner; ignored", flag)

    try:
        runner = VideoRunner(
            config,
            seed=args.seed,
            skip_type=args.skip_type,
            eta=args.eta,
            mesh=mesh,
            data_axis="data",
            cp_axis="context" if args.context_parallel > 0 else None,
            log_dir=args.log_path,
            use_ema_eval=args.use_ema_eval,
            denoiser_impl=resolve_impl(args.denoiser_impl),
            train_impl=resolve_impl(args.train_impl),
            dropout_impl=args.dropout_impl,
            exec_cache=args.exec_cache,
            kernel_precision=args.kernel_precision,
            eval_matmul_precision=args.matmul_precision,
            train_matmul_precision=args.matmul_precision,
            device=args.device,
        )
        runner.create_video_model(args.model_diff_path)

        if args.synthetic_windows > 0:
            from diffpose_tpu_torch.data.video import synthetic_video_dataset

            runner.set_data(
                synthetic_video_dataset(args.synthetic_windows, config.video.frames,
                                        seed=args.seed),
                synthetic_video_dataset(max(args.synthetic_windows // 4, 1), config.video.frames,
                                        seed=args.seed + 1),
            )
        else:
            runner.prepare_data()

        if args.train:
            runner.train(resume=args.resume)
        else:
            p1, p2 = runner.evaluate()
            logging.info("Final | MPJPE: %.2f mm | P-MPJPE: %.2f mm", p1, p2)
            if args.track_metrics:
                logging.info("throughput: %s", runner.throughput_stats())
    except Exception:
        logging.error(traceback.format_exc())
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
