"""Frame-based DiffPose CLI (capability parity with
``main_diffpose_frame.py`` of the reference; counterpart of
``diffpose_tpu/cli/main_frame.py``).  Runs on ``--device cuda`` unless told
``--device cpu``.

Train:
    python -m diffpose_tpu_torch.cli.main_frame --train --config configs/human36m_diffpose_uvxyz_cpn.yml \
        --doc run1 --batch_size 1024 --ni
Eval:
    python -m diffpose_tpu_torch.cli.main_frame --config configs/human36m_diffpose_uvxyz_cpn.yml \
        --doc eval1 --model_diff_path ckpt.pth --model_pose_path gcn.pth --ni
Data-parallel over two GPUs (one process a rank, nccl); add --hypothesis_parallel 2
for a data x hypothesis grid, and --device cpu for gloo on the CPU:
    torchrun --nproc_per_node 2 -m diffpose_tpu_torch.cli.main_frame --train --data_parallel \
        --config configs/human36m_diffpose_uvxyz_cpn.yml --doc run2 --batch_size 1024 --ni
Smoke (no dataset files needed):
    python -m diffpose_tpu_torch.cli.main_frame --config configs/human36m_diffpose_uvxyz_gt.yml \
        --doc smoke --train --synthetic_frames 2048 --batch_size 256 --ni \
        --train_impl fused --dropout_impl prng --denoiser_impl fused
"""

from __future__ import annotations

import argparse
import logging
import sys
import traceback

from diffpose_tpu_torch.cli.common import (
    add_common_flags,
    make_mesh_if_requested,
    resolve_action_filter,
    resolve_impl,
    setup_experiment,
)
from diffpose_tpu_torch.parallel.mesh import barrier


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    add_common_flags(parser)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    with make_mesh_if_requested(args) as mesh:   # before the log dir: only rank 0 writes it
        return _run(args, mesh)


def _run(args, mesh) -> int:
    config = setup_experiment(args)
    barrier()   # every rank sees the log dir rank 0 made
    logging.info("Writing log file to %s", args.log_path)
    logging.info("Exp instance id = %s", args.doc)

    from diffpose_tpu_torch.train.trainer import DiffposeRunner

    try:
        runner = DiffposeRunner(
            config,
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
    except Exception:
        logging.error(traceback.format_exc())
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
