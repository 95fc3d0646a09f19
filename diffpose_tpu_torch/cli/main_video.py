"""Video-family CLI: train and evaluate the spatio-temporal diffusion model
(counterpart of ``diffpose_tpu/cli/main_video.py``).  Runs on ``--device
cuda`` unless told ``--device cpu``.

The frame CLI's flags, plus ``--frames`` (window length) and
``--synthetic_windows``.  ``--context_parallel``, ``--data_parallel`` and
``--hypothesis_parallel`` need the video family's sharded steps (ROADMAP
queue 1 item 12c) and raise.  ``--model_diff_path`` loads a checkpoint ``.pth`` of this CLI for
an eval-only run.

Train, resume, eval-only (no dataset files needed):
    python -m diffpose_tpu_torch.cli.main_video --config configs/human36m_video.yml \\
        --doc run1 --train --ni --synthetic_windows 128 \\
        --train_impl fused --dropout_impl prng --denoiser_impl fused_full
    ... the same with --resume --n_epochs N
    python -m diffpose_tpu_torch.cli.main_video --config configs/human36m_video.yml \\
        --doc eval1 --ni --synthetic_windows 128 --denoiser_impl fused_st \\
        --model_diff_path exp/run1/ckpt_<step>.pth
"""

from __future__ import annotations

import argparse
import logging
import sys
import traceback

from diffpose_tpu_torch.cli.common import (
    add_common_flags,
    resolve_impl,
    setup_experiment,
)


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_flags(parser)
    parser.add_argument("--frames", type=int, default=None,
                        help="override video.frames (window length, e.g. 81/243)")
    parser.add_argument("--context_parallel", type=int, default=0, metavar="N",
                        help="shard the frame axis over N devices (not ported yet: raises, "
                        "ROADMAP item 12c)")
    parser.add_argument("--synthetic_windows", default=0, type=int,
                        help="use a synthetic dataset of N windows (smoke runs)")
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.context_parallel > 0 or args.data_parallel or args.hypothesis_parallel:
        raise NotImplementedError(
            "--context_parallel, --data_parallel and --hypothesis_parallel of the video family "
            "need its sharded steps and the K/V all-gather (ROADMAP queue 1 item 12c), which "
            "are not written yet")
    config = setup_experiment(args)

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
