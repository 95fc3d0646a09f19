"""Port DiffposeRunner on the CPU: the train/eval cycle, full resume, the eval
cache, what raises, and eval-only from a .pth against the JAX runner."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from diffpose_tpu import config as jconfig
from diffpose_tpu.models import GCNDiff as JGCNDiff
from diffpose_tpu.models import GCNPose as JGCNPose
from diffpose_tpu.models import convert as jconvert
from diffpose_tpu.train import DiffposeRunner as JDiffposeRunner
from diffpose_tpu_torch import config as tconfig
from diffpose_tpu_torch.data.synthetic import make_synthetic_dataset
from diffpose_tpu_torch.ops import fused_train as ft
from diffpose_tpu_torch.train.implicit_runner import ImplicitRunner
from diffpose_tpu_torch.train.trainer import DiffposeRunner
from test_torch_models import BASIS, perturbed

# Small tensors on a host that runs several test workers: one thread each is
# faster than contended thread pools.
torch.set_num_threads(1)


def tiny_config(batch_size=32, n_epochs=2):
    return tconfig.Config(
        model=tconfig.ModelConfig(hid_dim=32, num_layer=2, n_head=4),
        training=tconfig.TrainingConfig(batch_size=batch_size, n_epochs=n_epochs),
        testing=tconfig.TestingConfig(test_times=1, test_timesteps=2,
                                      test_num_diffusion_timesteps=12),
        optim=tconfig.OptimConfig(lr=1e-3),
    )


def make_runner(cfg, log_dir=None, seed=7, **kw):
    runner = DiffposeRunner(cfg, log_dir=log_dir, seed=seed, device="cpu", **kw)
    runner.create_diffusion_model()
    runner.create_pose_model()
    return runner


@pytest.mark.parametrize("impls", [
    dict(train_impl="module", denoiser_impl="module"),
    dict(train_impl="fused", dropout_impl="prng", denoiser_impl="fused"),
    dict(train_impl="fused", dropout_impl="masks", denoiser_impl="fused", train_sweep=2),
    dict(train_impl="plain", dropout_impl="prng", denoiser_impl="module", eval_sweep=2),
], ids=["module", "fused_prng", "fused_masks_sweep", "plain_prng"])
def test_runner_train_eval_cycle(tmp_path, impls):
    runner = make_runner(tiny_config(), str(tmp_path / "ckpt"), **impls)
    runner.set_data(make_synthetic_dataset(num_frames=96, seed=0),
                    make_synthetic_dataset(num_frames=48, seed=1))
    history = runner.train()
    assert len(history["loss"]) == len(history["p1"]) == len(runner.train_seconds) == 2
    assert all(np.isfinite(history["loss"])) and all(np.isfinite(history["p1"]))
    assert runner.state.step == 6 and runner.state.epoch == 2
    stats = runner.throughput_stats()
    assert stats["eval_frames"] == 48 and stats["frames_per_second"] > 0
    rows = (tmp_path / "ckpt" / "log.tsv").read_text().splitlines()
    assert rows[0].split("\t")[:5] == ["Epoch", "LR", "Train Loss", "Test MPJPE", "Test P-MPJPE"]
    assert len(rows) == 3 and float(rows[2].split("\t")[3]) == pytest.approx(history["p1"][1], abs=1e-5)
    assert runner.checkpointer.all_steps() == [3, 6]
    assert runner._eval_builds == 1          # two epochs, one eval step built


def test_same_seed_same_run_and_prng_equals_plain_prng():
    """Equal seeds give equal runs; the fused prng step and the plain step
    over philox_masks draw the same masks, so their runs agree too."""
    losses = []
    for impl in ("fused", "fused", "plain"):
        runner = make_runner(tiny_config(n_epochs=1), train_impl=impl, dropout_impl="prng", seed=11)
        runner.set_data(make_synthetic_dataset(num_frames=64, seed=2), None)
        losses.append(runner.train()["loss"][0])
    assert losses[0] == losses[1]
    assert losses[2] == pytest.approx(losses[0], rel=1e-5)
    other = make_runner(tiny_config(n_epochs=1), train_impl="fused", dropout_impl="prng", seed=12)
    other.set_data(make_synthetic_dataset(num_frames=64, seed=2), None)
    assert other.train()["loss"][0] != losses[0]


def test_runner_full_resume(tmp_path, caplog):
    train = make_synthetic_dataset(num_frames=64, seed=2)
    runner = make_runner(tiny_config(n_epochs=1), str(tmp_path / "ck"), seed=3, train_impl="fused",
                         dropout_impl="prng")
    runner.set_data(train, None)
    runner.train()
    assert runner.state.step == 2       # 64 / 32 batches
    moments = [v["exp_avg"].clone() for v in runner.state.optimizer.inner.state.values()]

    # A fresh runner with another seed resumes weights, moments, EMA, epoch and step.
    runner2 = make_runner(tiny_config(n_epochs=2), str(tmp_path / "ck"), seed=99, train_impl="fused",
                          dropout_impl="prng")
    runner2.set_data(train, None)
    restored, _ = runner2.checkpointer.restore(runner2.init_state(runner2._build_train_step(2)[0]))
    for a, b in zip(runner.model_diff.parameters(), restored.model.parameters()):
        assert torch.equal(a, b)
    assert all(torch.equal(a, b["exp_avg"]) for a, b in
               zip(moments, restored.optimizer.inner.state.values()))
    assert all(torch.equal(runner.state.ema_params[k], restored.ema_params[k])
               for k in restored.ema_params)
    runner2.state = None
    with caplog.at_level("INFO"):
        runner2.train(resume=True)
    assert "resumed from step 2 (epoch 1)" in caplog.text
    assert (runner2.state.epoch, runner2.state.step) == (2, 4)   # only epoch 1 ran now
    assert runner2.state.optimizer.count == 4
    assert len((tmp_path / "ck" / "log.tsv").read_text().splitlines()) == 3


def test_second_evaluate_builds_nothing_and_is_deterministic():
    runner = make_runner(tiny_config(), denoiser_impl="fused")
    runner.set_data(None, make_synthetic_dataset(num_frames=50, seed=1))
    a = runner.evaluate(is_train=True)
    assert runner._eval_builds == 1
    b = runner.evaluate(is_train=True)
    assert runner._eval_builds == 1 and a == b and runner.eval_frames == 50
    module = make_runner(tiny_config(), denoiser_impl="module")
    module.set_data(None, runner.test_data)
    assert module.evaluate(is_train=True) == pytest.approx(a, abs=1e-2)   # same seed, same weights


@pytest.mark.parametrize("family", ["frame", "implicit"])
def test_eval_sweep_gives_the_same_results(family):
    """``eval_sweep`` 2 (two batches a host synchronisation) gives the P1/P2
    and the per-action sums of 1 in the frame and implicit families' one eval
    loop; the implicit runner carries its warm start from batch to batch."""
    cfg = tiny_config()
    cfg.testing.test_times = 2
    cfg.implicit = tconfig.ImplicitConfig(max_iterations=6, min_iterations=3, use_warm_start=True)
    data = make_synthetic_dataset(num_frames=80, seed=1)      # 3 batches of 32, the last wrapped
    got = []
    for sweep in (1, 2):
        if family == "frame":
            runner = make_runner(cfg, seed=5, denoiser_impl="fused", eval_sweep=sweep)
        else:
            runner = ImplicitRunner(cfg, seed=5, device="cpu", denoiser_impl="fused",
                                    eval_sweep=sweep)
            runner.create_diffusion_model()
            runner.create_pose_model()
        runner.set_data(None, data)
        p1_p2 = runner.evaluate(is_train=True)
        sums = {(a, k): (v.sum, v.count) for a, d in runner.last_error_sum.items()
                for k, v in d.items()}
        got.append((p1_p2, sums, getattr(runner, "fp_iterations", None)))
        assert len(runner.inference_times) == (3 if sweep == 1 else 2)   # one time a group
    assert got[0] == got[1]


@pytest.mark.parametrize("variants,exc,match", [
    ([dict(mesh=object())], TypeError, "DeviceMesh"),
    ([dict(kernel_precision="fp8", train_impl="fused"),
      dict(kernel_precision="highest", train_impl="plain")],
     ValueError, "kernel tier must be one of"),
    ([dict(train_matmul_precision="bf16"), dict(eval_matmul_precision="highest"),
      dict(kernel_precision="fp8")], ValueError, "must be one of"),
    ([dict(denoiser_impl="pallas_full"), dict(denoiser_impl="pallas_st")], ValueError,
     "video family"),
    ([dict(train_impl="pallas"), dict(dropout_impl="tpu"), dict(denoiser_impl="xla")],
     ValueError, "_impl must be one of"),
], ids=["mesh", "kernel_tiers", "matmul_tiers", "video_kernels", "unknown_values"])
def test_what_has_no_counterpart_raises(variants, exc, match):
    for kwargs in variants:
        with pytest.raises(exc, match=match):
            DiffposeRunner(tiny_config(), device="cpu", **kwargs)


def test_default_device_is_cuda_and_raises_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        DiffposeRunner(tiny_config())


def test_eval_only_from_pth_agrees_with_the_jax_runner(tmp_path, capsys):
    """The same weights (written by the JAX package's save_torch_states), the
    same one-component synthetic set: the two runners' evaluate() agree."""
    m = dict(hid_dim=32, num_layers=2, num_heads=4)
    dparams = perturbed(JGCNDiff(basis=BASIS, **m).init(
        {"params": jax.random.PRNGKey(0)}, jnp.zeros((2, 17, 5)), jnp.zeros((2,)))["params"], 0)
    pparams = perturbed(JGCNPose(basis=BASIS, **m).init(
        {"params": jax.random.PRNGKey(1)}, jnp.zeros((2, 17, 2)))["params"], 1)
    paths = {}
    for name, params, with_temb in (("diff", dparams, True), ("pose", pparams, False)):
        paths[name] = str(tmp_path / f"{name}.pth")
        jconvert.save_torch_states(paths[name], jconvert.params_to_torch_state(
            params, num_layers=2, with_temb=with_temb, hid_dim=32))
    test = make_synthetic_dataset(num_frames=70, seed=5)
    test.poses_2d_gmm[..., 0] = 0.0
    test.poses_2d_gmm[..., 1, 0] = 1.0           # all weight on one kernel

    jcfg = jconfig.Config(model=jconfig.ModelConfig(hid_dim=32, num_layer=2, n_head=4),
                          training=jconfig.TrainingConfig(batch_size=32),
                          testing=jconfig.TestingConfig(test_times=2, test_timesteps=2,
                                                        test_num_diffusion_timesteps=12))
    jrunner = JDiffposeRunner(jcfg, seed=7)
    jrunner.create_diffusion_model(paths["diff"])
    jrunner.create_pose_model(paths["pose"])
    jrunner.set_data(None, test)
    want = jrunner.evaluate()
    want_table = capsys.readouterr().out

    cfg = tiny_config()
    cfg.testing.test_times = 2
    for impl in ("module", "fused"):
        runner = DiffposeRunner(cfg, seed=7, device="cpu", denoiser_impl=impl)
        runner.create_diffusion_model(paths["diff"])
        runner.create_pose_model(paths["pose"])
        runner.set_data(None, test)
        got = runner.evaluate()
        table = capsys.readouterr().out
        assert got == pytest.approx(want, abs=1e-3), impl          # mm
        assert runner.eval_frames == jrunner.eval_frames == 70
        # the tables agree up to the rounding of their two decimals
        rows, want_rows = table.splitlines(), want_table.splitlines()
        assert len(rows) == len(want_rows) == 17 and rows[0] == want_rows[0]
        for row, want_row in zip(rows[1:], want_rows[1:]):
            assert row.split()[0] == want_row.split()[0]
            assert [float(v) for v in row.split()[1:]] == pytest.approx(
                [float(v) for v in want_row.split()[1:]], abs=0.011)
    assert ft.stack_fwd_prng.launches == 0
