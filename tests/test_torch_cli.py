"""Port CLI and config on the CPU: flags, config round trip and override
rules, train / resume / eval-only runs with --device cpu."""

import argparse
import glob
import os

import pytest
import torch

from diffpose_tpu import config as jconfig
from diffpose_tpu.cli import common as jcommon
from diffpose_tpu_torch import config as tconfig
from diffpose_tpu_torch.cli import common, main_frame
from diffpose_tpu_torch.utils import Logger

# Small tensors on a host that runs several test workers: one thread each is
# faster than contended thread pools.
torch.set_num_threads(1)

GT = "configs/human36m_diffpose_uvxyz_gt.yml"
CPN = "configs/human36m_diffpose_uvxyz_cpn.yml"
# what the port's command line adds, and the choices it widens
ADDED_FLAGS = {"device"}
CHOICES = {"train_impl": ("module", "plain", "fused", "pallas"),
           "denoiser_impl": ("module", "fused", "pallas", "fused_st", "pallas_st", "fused_full",
                             "pallas_full")}


def flags(mod):
    parser = mod.add_common_flags(argparse.ArgumentParser())
    return {a.dest: a for a in parser._actions if a.dest != "help"}


def test_every_flag_keeps_its_name_and_default():
    ours, theirs = flags(common), flags(jcommon)
    assert set(ours) - set(theirs) == ADDED_FLAGS and set(theirs) <= set(ours)
    for name, action in theirs.items():
        assert ours[name].default == action.default, name
        assert ours[name].option_strings == action.option_strings, name
        assert ours[name].required == action.required and ours[name].type == action.type, name
        if name in CHOICES:
            assert tuple(ours[name].choices) == CHOICES[name]
            assert set(action.choices) <= set(ours[name].choices)
        else:
            assert ours[name].choices == action.choices, name
    assert ours["device"].default == "cuda"
    assert common.resolve_impl("pallas") == "fused" and common.resolve_impl("module") == "module"
    assert common.resolve_impl("pallas_st") == "fused_st"
    assert common.resolve_impl("pallas_full") == "fused_full"


@pytest.mark.parametrize("path", sorted(glob.glob("configs/*.yml")))
def test_config_loads_and_round_trips_like_jax(tmp_path, path):
    cfg, jcfg = tconfig.load_config(path), jconfig.load_config(path)
    assert tconfig.config_to_dict(cfg) == jconfig.config_to_dict(jcfg)
    tconfig.save_config(cfg, str(tmp_path / "config.yml"))
    again = tconfig.load_config(str(tmp_path / "config.yml"))
    assert tconfig.config_to_dict(again) == tconfig.config_to_dict(cfg)
    assert (cfg.implicit is None) == (jcfg.implicit is None)
    assert (cfg.video is None) == (jcfg.video is None)


def test_config_cli_override_rules():
    cfg = tconfig.load_config(CPN)
    assert cfg.training.batch_size == 1024
    assert cfg.testing.test_num_diffusion_timesteps == 24
    cfg2 = tconfig.load_config(CPN, cli_overrides={"batch_size": 256, "lr": 1e-3})
    assert cfg2.training.batch_size == 256 and cfg2.optim.lr == 1e-3
    with pytest.raises(ValueError):
        tconfig.load_config(CPN, cli_overrides={"bogus": 1})
    ipose = tconfig.load_config("configs/human36m_ipose.yml")
    assert ipose.implicit.solver == "anderson" and ipose.implicit.anderson_m == 5


def test_cli_train_resume_and_eval_only_on_cpu(tmp_path, capsys):
    base = ["--config", GT, "--exp", str(tmp_path), "--ni", "--synthetic_frames", "96",
            "--batch_size", "48", "--device", "cpu", "--denoiser_impl", "fused"]
    train = base + ["--doc", "run", "--train", "--train_impl", "pallas", "--dropout_impl", "prng",
                    "--lr", "0.001"]
    assert main_frame.main(train + ["--n_epochs", "1"]) == 0
    run = tmp_path / "run"
    for name in ("config.yml", "stdout.txt", "log.tsv", "ckpt_00000002.pth",
                 "ckpt_00000002.pose.pth"):
        assert (run / name).exists(), name
    saved = tconfig.load_config(str(run / "config.yml"))
    assert saved.training.batch_size == 48 and saved.optim.lr == 1e-3
    assert saved.training.n_epochs == 1

    assert main_frame.main(train + ["--n_epochs", "2", "--resume"]) == 0
    log = (run / "stdout.txt").read_text()
    assert "resumed from step 2 (epoch 1)" in log and log.count("| Epoch 00") == 2
    assert len((run / "log.tsv").read_text().splitlines()) == 3
    assert (run / "ckpt_00000004.pth").exists()

    capsys.readouterr()
    assert main_frame.main(base + [
        "--doc", "ev", "--track_metrics", "--test_times", "2",
        "--model_diff_path", str(run / "ckpt_00000004.pth"),
        "--model_pose_path", str(run / "ckpt_00000004.pose.pth")]) == 0
    out = capsys.readouterr().out
    assert out.startswith("===Action===") and "Average" in out
    ev = (tmp_path / "ev" / "stdout.txt").read_text()
    assert "Final | MPJPE:" in ev and "throughput: {" in ev
    assert not (tmp_path / "ev" / "config.yml").exists()


def test_ni_overwrites_an_existing_run(tmp_path):
    args = ["--config", GT, "--exp", str(tmp_path), "--doc", "t", "--train", "--ni",
            "--n_epochs", "1", "--synthetic_frames", "32", "--batch_size", "32", "--device", "cpu"]
    (tmp_path / "t").mkdir()
    (tmp_path / "t" / "stale.txt").write_text("x")
    assert main_frame.main(args) == 0
    assert not (tmp_path / "t" / "stale.txt").exists() and (tmp_path / "t" / "log.tsv").exists()


@pytest.mark.parametrize("flag", [["--data_parallel"], ["--hypothesis_parallel", "2"]],
                         ids=["data_parallel", "hypothesis_parallel"])
def test_mesh_flags_raise(tmp_path, flag):
    """The mesh flags in a world of one rank (no launcher): --data_parallel
    trains over a 1-rank data mesh; --hypothesis_parallel 2 raises, as the
    world does not divide by 2.  Either way the process group is left."""
    args = ["--config", GT, "--exp", str(tmp_path), "--doc", "t", "--ni",
            "--synthetic_frames", "32", "--batch_size", "16", "--device", "cpu"] + flag
    if flag == ["--data_parallel"]:
        assert main_frame.main(args + ["--train", "--n_epochs", "1"]) == 0
        assert len((tmp_path / "t" / "log.tsv").read_text().splitlines()) == 2
        assert (tmp_path / "t" / "ckpt_00000002.pth").exists()
    else:
        with pytest.raises(ValueError, match="1 ranks not divisible by hypothesis_parallel=2"):
            main_frame.main(args)
    assert not torch.distributed.is_initialized()


def test_unported_tiers_fail_the_run_and_the_default_device_is_the_card(tmp_path, monkeypatch):
    base = ["--config", GT, "--exp", str(tmp_path), "--doc", "t", "--ni",
            "--synthetic_frames", "32", "--batch_size", "32"]
    assert main_frame.main(base + ["--device", "cpu", "--kernel_precision", "bf16"]) == 1
    assert "f32 grade" in (tmp_path / "t" / "stdout.txt").read_text()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert main_frame.main(base) == 1            # no --device: cuda, and there is none
    assert "device='cpu'" in (tmp_path / "t" / "stdout.txt").read_text()


def test_tsv_logger_resume_appends(tmp_path):
    path = str(tmp_path / "log.tsv")
    log = Logger(path, title="t")
    log.set_names(["Epoch", "Loss"])
    log.append([0, 1.5])
    log.close()
    log = Logger(path, title="t", resume=True)
    assert log.names == ["Epoch", "Loss"]
    log.append([1, 1.25])
    log.close()
    assert open(path).read().splitlines() == ["Epoch\tLoss\t", "0.000000\t1.500000\t",
                                              "1.000000\t1.250000\t"]
    assert os.path.exists(path)
