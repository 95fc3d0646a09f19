"""Port video runner and CLI (diffpose_tpu_torch.cli.main_video) on the CPU, and
its data preparation vs the JAX runner's (diffpose_tpu/train/video_runner.py)."""

import re

import numpy as np
import pytest
import torch

from diffpose_tpu.config import load_config as j_load_config
from diffpose_tpu.train.video_runner import VideoRunner as JVideoRunner
from diffpose_tpu_torch.cli import main_video
from diffpose_tpu_torch.config import load_config
from diffpose_tpu_torch.models.convert import load_torch_states
from diffpose_tpu_torch.parallel.mesh import distributed_init, distributed_shutdown, make_mesh
from diffpose_tpu_torch.train.video_runner import VideoRunner
from test_torch_pipeline_data import fabricate

torch.set_num_threads(1)

VIDEO = "configs/human36m_video.yml"


def _cli(tmp_path, *extra):
    return ["--config", VIDEO, "--exp", str(tmp_path), "--ni", "--frames", "9",
            "--synthetic_windows", "16", "--batch_size", "4", "--device", "cpu", *extra]


def errors(path):
    return re.findall(r" - MPJPE: ([0-9.]+) \| P-MPJPE: ([0-9.]+)", path.read_text())


def test_cli_trains_resumes_and_evaluates_the_checkpoint_with_every_impl(tmp_path):
    train = _cli(tmp_path, "--doc", "run", "--train", "--train_impl", "fused", "--dropout_impl",
                 "prng", "--denoiser_impl", "fused", "--eval_sweep", "2")
    assert main_video.main(train + ["--n_epochs", "1"]) == 0
    run = tmp_path / "run"
    log = (run / "stdout.txt").read_text()
    assert "training windows: 16 × 9 frames" in log and "--eval_sweep is not supported" in log
    assert main_video.main(train + ["--n_epochs", "2", "--resume"]) == 0
    log = (run / "stdout.txt").read_text()
    assert "resumed from step 4 (epoch 1)" in log and log.count("| Epoch 00") == 2
    assert {p.name for p in run.iterdir()} >= {"config.yml", "stdout.txt", "ckpt_00000004.pth",
                                               "ckpt_00000008.pth"}
    assert "temporal_3.ff2.weight" in load_torch_states(str(run / "ckpt_00000008.pth"))[0]
    last = errors(run / "stdout.txt")[-1]
    for impl in ("pallas", "fused_st", "pallas_full", "module"):
        assert main_video.main(_cli(tmp_path, "--doc", f"ev_{impl}", "--track_metrics",
                                    "--denoiser_impl", impl, "--model_diff_path",
                                    str(run / "ckpt_00000008.pth"))) == 0
        ev = tmp_path / f"ev_{impl}" / "stdout.txt"
        assert "Final | MPJPE:" in ev.read_text() and "throughput: {" in ev.read_text()
        np.testing.assert_allclose(np.asarray(errors(ev)[-1], float), np.asarray(last, float),
                                   atol=2e-3, err_msg=impl)


@pytest.mark.parametrize("flag", [["--context_parallel", "1"], ["--data_parallel"],
                                  ["--hypothesis_parallel", "2"]],
                         ids=["context_parallel", "data_parallel", "hypothesis_parallel"])
def test_mesh_flags_raise(tmp_path, flag):
    """The mesh flags in a world of one rank (no launcher): --data_parallel and
    --context_parallel 1 train over a 1-rank mesh and write one checkpoint;
    --hypothesis_parallel has no video counterpart and raises.  Either way the
    process group is left."""
    args = _cli(tmp_path, "--doc", "t", "--train", "--n_epochs", "1", *flag)
    if flag[0] == "--hypothesis_parallel":
        with pytest.raises(ValueError, match="no hypothesis axis"):
            main_video.main(args)
    else:
        assert main_video.main(args) == 0
        assert {p.name for p in (tmp_path / "t").glob("ckpt_*")} == {"ckpt_00000004.pth"}
        assert "| Epoch 0000 |" in (tmp_path / "t" / "stdout.txt").read_text()
    assert not torch.distributed.is_initialized()


def test_runner_refuses_what_has_no_counterpart_and_evaluates_twice_alike():
    config = load_config(VIDEO)
    config.video.frames, config.video.num_layers, config.training.batch_size = 5, 1, 2
    for kwargs, exc in ((dict(mesh=object()), TypeError),
                        (dict(denoiser_impl="pallas_full"), ValueError),
                        (dict(kernel_precision="bf16"), NotImplementedError)):
        with pytest.raises(exc):
            VideoRunner(config, device="cpu", **kwargs)
    # whole-window paths under a context axis (a world of one): refused, not replaced
    distributed_init(device="cpu")
    try:
        mesh = make_mesh((1,), ("context",), device_type="cpu")
        for kwargs in (dict(train_impl="fused"), dict(denoiser_impl="fused_st")):
            with pytest.raises(ValueError, match="does not compose with context parallelism"):
                VideoRunner(config, device="cpu", mesh=mesh, cp_axis="context", **kwargs)
    finally:
        distributed_shutdown()
    from diffpose_tpu_torch.data.video import synthetic_video_dataset

    runner = VideoRunner(config, device="cpu", denoiser_impl="fused_full")
    runner.create_video_model()
    runner.set_data(None, synthetic_video_dataset(3, 5, seed=1))
    a = runner.evaluate(is_train=True)
    assert runner.eval_frames == 15 and runner.evaluate(is_train=True) == a
    assert runner.throughput_stats()["eval_frames"] == 15


def test_prepare_data_equals_the_jax_runner(tmp_path, rng):
    p3, p2 = fabricate(tmp_path, rng)
    windows = {}
    for name, load, cls in (("port", load_config, VideoRunner), ("jax", j_load_config, JVideoRunner)):
        config = load(VIDEO)
        config.data.dataset_path, config.data.dataset_path_train_2d = p3, p2
        config.data.dataset_path_test_2d = p2
        config.video.frames, config.video.train_stride = 4, 2
        runner = cls(config, device="cpu") if name == "port" else cls(config)
        runner.prepare_data()
        windows[name] = (runner.train_data, runner.test_data)
    for ours, theirs in zip(windows["port"], windows["jax"]):
        assert len(ours) > 0 and ours.actions == theirs.actions
        for field in ("poses_3d", "poses_2d_gmm", "action_ids"):
            np.testing.assert_array_equal(getattr(ours, field), getattr(theirs, field))
