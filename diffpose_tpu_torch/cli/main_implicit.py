"""Implicit-pose CLI (capability parity with the reference's
``main_implicit_pose.py``; counterpart of ``diffpose_tpu/cli/main_implicit.py``).
Runs on ``--device cuda`` unless told ``--device cpu``.

The implicit-solver flags on top of the frame CLI's.  The reference's
GPU-memory chunking flags (``--process_chunk_size`` and the rest) are
accepted and ignored with a warning: a batch of the solve fits the card
whole.

Train, resume, eval-only (no dataset files needed):
    python -m diffpose_tpu_torch.cli.main_implicit --config configs/human36m_ipose.yml \
        --doc run1 --train --ni --use_implicit --synthetic_frames 4096 \
        --train_impl fused --dropout_impl prng --denoiser_impl fused
    ... the same with --resume --n_epochs N
    python -m diffpose_tpu_torch.cli.main_implicit --config configs/human36m_ipose.yml \
        --doc eval1 --ni --use_implicit --synthetic_frames 4096 --denoiser_impl fused \
        --model_diff_path exp/run1/ckpt_<step>.pth --model_pose_path exp/run1/ckpt_<step>.pose.pth
"""

from __future__ import annotations

import argparse
import logging
import sys
import traceback

import numpy as np
import torch

from diffpose_tpu_torch.cli.common import (
    add_common_flags,
    make_mesh_if_requested,
    resolve_action_filter,
    resolve_impl,
    setup_experiment,
)
from diffpose_tpu_torch.parallel.mesh import barrier

_IGNORED = ("use_memory_efficient", "use_dynamic_chunks", "expandable_segments",
            "process_chunk_size", "min_chunk_size", "max_chunk_size", "target_memory_usage")


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_flags(parser)
    parser.add_argument("--use_implicit", action="store_true",
                        help="use the IGCN fixed-point model instead of GCNDiff")
    parser.add_argument("--implicit_iters", type=int, default=None,
                        help="max fixed-point iterations")
    parser.add_argument("--implicit_tol", type=float, default=None,
                        help="fixed-point convergence tolerance")
    parser.add_argument("--min_iterations", type=int, default=None,
                        help="minimum iterations before convergence can trigger")
    parser.add_argument("--use_warm_start", action="store_true")
    parser.add_argument("--detect_anomaly", action="store_true",
                        help="torch.autograd.set_detect_anomaly(True): the backward raises "
                        "at the operator whose gradient is NaN (main_implicit_pose.py:101-102)")
    # accepted for the reference's command lines; a batch of the solve fits the card whole
    for flag in ("--use_memory_efficient", "--use_dynamic_chunks", "--expandable_segments"):
        parser.add_argument(flag, action="store_true", help=argparse.SUPPRESS)
    for flag in ("--process_chunk_size", "--min_chunk_size", "--max_chunk_size"):
        parser.add_argument(flag, type=int, default=None, help=argparse.SUPPRESS)
    parser.add_argument("--target_memory_usage", type=float, default=None,
                        help=argparse.SUPPRESS)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    with make_mesh_if_requested(args) as mesh:   # before the log dir: only rank 0 writes it
        return _run(args, mesh)


def _run(args, mesh) -> int:
    config = setup_experiment(args)
    barrier()   # every rank sees the log dir rank 0 made
    logging.info("Writing log file to %s", args.log_path)

    from diffpose_tpu_torch.config import ImplicitConfig
    from diffpose_tpu_torch.train.implicit_runner import ImplicitRunner

    if config.implicit is None:
        config.implicit = ImplicitConfig()
    if args.implicit_iters is not None:
        config.implicit.max_iterations = args.implicit_iters
    if args.implicit_tol is not None:
        config.implicit.tolerance = args.implicit_tol
    if args.min_iterations is not None:
        config.implicit.min_iterations = args.min_iterations
    if args.use_warm_start:
        config.implicit.use_warm_start = True
    torch.autograd.set_detect_anomaly(args.detect_anomaly)
    if args.detect_anomaly:
        logging.info("anomaly detection on: torch.autograd.set_detect_anomaly(True)")
    for name in _IGNORED:
        if getattr(args, name):
            logging.warning("--%s has no effect here (no chunking of the solve); ignored", name)
    if args.use_implicit and args.eval_sweep > 1:
        logging.warning("--eval_sweep has no effect with --use_implicit")

    try:
        runner = ImplicitRunner(
            config,
            use_implicit=args.use_implicit,
            seed=args.seed,
            skip_type=args.skip_type,
            eta=args.eta,
            mesh=mesh,
            log_dir=args.log_path,
            use_ema_eval=args.use_ema_eval,
            downsample=args.downsample,
            action_filter=resolve_action_filter(args),
            eval_sweep=args.eval_sweep,
            train_sweep=args.train_sweep,
            denoiser_impl=resolve_impl(args.denoiser_impl),
            train_impl=resolve_impl(args.train_impl),
            exec_cache=args.exec_cache,
            kernel_precision=args.kernel_precision,
            dropout_impl=args.dropout_impl,
            eval_matmul_precision=args.matmul_precision,
            train_matmul_precision=args.matmul_precision,
            device=args.device,
        )
        runner.create_diffusion_model(args.model_diff_path)
        runner.create_pose_model(args.model_pose_path)

        if args.synthetic_frames > 0:
            from diffpose_tpu_torch.data.synthetic import make_synthetic_dataset

            runner.set_data(
                make_synthetic_dataset(args.synthetic_frames, seed=args.seed),
                make_synthetic_dataset(max(args.synthetic_frames // 4, 1), seed=args.seed + 1),
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
                if runner.fp_iterations:
                    logging.info("fixed-point iterations: mean %.1f min %d max %d",
                                 float(np.mean(runner.fp_iterations)),
                                 min(runner.fp_iterations), max(runner.fp_iterations))
    except Exception:
        logging.error(traceback.format_exc())
        return 1
    finally:
        torch.autograd.set_detect_anomaly(False)
    return 0


if __name__ == "__main__":
    sys.exit(main())
