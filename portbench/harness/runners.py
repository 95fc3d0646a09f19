"""The program's runners built as its command-line entries build them, their
models holding the weights made from the run's seed."""

from __future__ import annotations

import copy

from portbench.harness import data, weights


def frame_runner(ctx, test):
    """The runner as the frame CLI builds it, its models holding the seed's
    weights.  Returns ``(runner, config, diff_weights, pose_weights)``."""
    from diffpose_tpu_torch.config import config_from_dict
    from diffpose_tpu_torch.data.pipeline import FlatDataset
    from diffpose_tpu_torch.train.trainer import DiffposeRunner

    cfg = config_from_dict(copy.deepcopy(ctx.config["config"]))
    if "test_times" in ctx.cell:
        cfg.testing.test_times = int(ctx.cell["test_times"])
    r = ctx.config["runner"]
    runner = DiffposeRunner(
        cfg, seed=ctx.runner_seed, skip_type=r["skip_type"], eta=r["eta"],
        denoiser_impl=r["denoiser_impl"], train_impl=r["train_impl"],
        dropout_impl=r["dropout_impl"], kernel_precision=ctx.kernel_precision,
        eval_matmul_precision=r["matmul_precision"], train_matmul_precision=r["matmul_precision"],
        device=str(ctx.device))
    runner.create_diffusion_model(None)
    runner.create_pose_model(None)
    w_diff = weights.make(weights.shapes_of(runner.model_diff), ctx.seed, ctx.device)
    w_pose = weights.make(weights.shapes_of(runner.model_pose), ctx.seed + 1, ctx.device)
    runner.model_diff.load_state_dict(w_diff)
    runner.model_pose.load_state_dict(w_pose)

    runner.set_data(None, FlatDataset(test["poses_3d"], test["poses_2d_gmm"], test["action_ids"],
                                      test["camera_para"], data.ACTIONS))
    return runner, cfg, w_diff, w_pose
