"""Side-by-side comparison (capability parity with the reference's
``compare_methods.py``; counterpart of ``diffpose_tpu/cli/compare.py``): the
frame family's diffusion eval and the implicit family's direct-inference
eval on the same data and configuration, each with its seconds.

    python -m diffpose_tpu_torch.cli.compare --config configs/human36m_ipose.yml \
        --doc cmp --ni --synthetic_frames 2048 --denoiser_impl fused
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

import torch

from diffpose_tpu_torch.cli.common import (
    add_common_flags,
    make_mesh_if_requested,
    resolve_action_filter,
    resolve_impl,
    setup_experiment,
)
from diffpose_tpu_torch.parallel.mesh import barrier


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    add_common_flags(parser)
    return parser.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    with make_mesh_if_requested(args) as mesh:   # before the log dir: only rank 0 writes it
        return _run(args, mesh)


def _run(args, mesh) -> int:
    config = setup_experiment(args)
    barrier()   # every rank sees the log dir rank 0 made

    from diffpose_tpu_torch.config import ImplicitConfig
    from diffpose_tpu_torch.data.synthetic import make_synthetic_dataset
    from diffpose_tpu_torch.train.implicit_runner import ImplicitRunner
    from diffpose_tpu_torch.train.trainer import DiffposeRunner

    if config.implicit is None:
        config.implicit = ImplicitConfig()

    results = {}
    for name, cls, kwargs in (("diffusion", DiffposeRunner, {}),
                              ("implicit", ImplicitRunner, {"use_implicit": True})):
        runner = cls(config, seed=args.seed, skip_type=args.skip_type, eta=args.eta, mesh=mesh,
                     use_ema_eval=args.use_ema_eval, downsample=args.downsample,
                     action_filter=resolve_action_filter(args),
                     denoiser_impl=resolve_impl(args.denoiser_impl), device=args.device,
                     **kwargs)
        runner.create_diffusion_model(args.model_diff_path if name == "diffusion" else None)
        runner.create_pose_model(args.model_pose_path)
        if args.synthetic_frames > 0:
            runner.set_data(None, make_synthetic_dataset(args.synthetic_frames, seed=args.seed))
        else:
            runner.prepare_data()
        t0 = time.time()
        p1, p2 = runner.evaluate()
        if runner.device.type == "cuda":
            torch.cuda.synchronize(runner.device)
        results[name] = {"p1": p1, "p2": p2, "seconds": time.time() - t0}
        logging.info("[%s] MPJPE %.2f | P-MPJPE %.2f | %.1fs", name, p1, p2,
                     results[name]["seconds"])

    logging.info("comparison: %s", results)
    return 0


if __name__ == "__main__":
    sys.exit(main())
