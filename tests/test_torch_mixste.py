"""The MixSTE video denoiser (``diffpose_tpu_torch/models/mixste.py``) on the
CPU at a tiny size, against the benchmark's plain float64 reference
(``portbench/reference/mixste.py``) on seeded random weights: the forward on
both attention paths, the video eval step through ``VideoRunner``, the
refusals, a module train step with its checkpoint and EMA, the parameter
count at the published widths, the port-only configuration file and its
CLI run."""

import re

import numpy as np
import pytest
import torch

from diffpose_tpu_torch import config as tconfig
from diffpose_tpu_torch.cli import main_video
from diffpose_tpu_torch.data.video import VideoDataset, synthetic_video_dataset
from diffpose_tpu_torch.diffusion import make_skip_sequence
from diffpose_tpu_torch.models.convert import load_torch_states
from diffpose_tpu_torch.models.mixste import MixSTE
from diffpose_tpu_torch.train.video_runner import VideoRunner
from portbench.harness import windows
from portbench.harness.data import ACTIONS
from portbench.reference import mixste as ref
from portbench.reference import protocol

torch.set_num_threads(1)

MIXSTE = "configs/torch/human36m_video_mixste.yml"
TINY = dict(embed_dim=32, depth=2, num_heads=4)


def seeded(model, seed=0):
    """Random weights on every parameter (LayerNorm gains near 1), so that
    every term of the network is live."""
    gen = torch.Generator().manual_seed(seed)
    sd = {}
    for k, v in model.state_dict().items():
        z = torch.randn(v.shape, generator=gen)
        sd[k] = (1 + 0.1 * z if v.ndim == 1 and k.endswith("weight") else
                 z / v.shape[1] ** 0.5 if v.ndim == 2 else 0.1 * z)
    model.load_state_dict(sd)
    return {k: v.double() for k, v in sd.items()}


def tiny_config(frames=9, batch=2, test_times=3):
    cfg = tconfig.load_config(MIXSTE)
    cfg.mixste = tconfig.MixSTEConfig(**TINY)
    cfg.video.frames = cfg.video.eval_stride = frames
    cfg.training.batch_size, cfg.testing.test_times = batch, test_times
    return cfg


@pytest.mark.parametrize("chunk,path", [(256, "materialised"), (4, "chunked")])
def test_forward_matches_the_reference(chunk, path):
    torch.manual_seed(0)
    model = MixSTE(9, attention_chunk=chunk, **TINY).eval()
    p = seeded(model)
    x, t = torch.randn(3, 9, 17, 5), torch.tensor([0.0, 12.0, 5.0])
    with torch.no_grad():
        out = model(x, t)
    want = ref.forward_blocks(p, x.double(), t.double(), 2, depth=2, heads=4, ln_eps=1e-6)
    # float32 rounding through 4 blocks and 5 LayerNorms: a few ulps of O(1) values
    np.testing.assert_allclose(out.double().numpy(), want.numpy(), rtol=0, atol=2e-5)
    assert model.temporal_paths == {path: 2}


def test_dropout_follows_training():
    torch.manual_seed(0)
    model = MixSTE(9, dropout_rate=0.5, **TINY)
    seeded(model)
    x, t = torch.randn(2, 9, 17, 5), torch.tensor([1.0, 2.0])
    assert not torch.equal(model(x, t), model(x, t))
    model.eval()
    assert torch.equal(model(x, t), model(x, t))


def test_eval_step_matches_the_reference_protocol():
    """One batch of ``make_video_eval_step`` on the MixSTE denoiser (per-frame
    GMM draw, 2 DDIM steps, 3 hypotheses, their mean, per-frame errors)
    against the reference's protocol on the same weights and windows."""
    cfg = tiny_config()
    runner = VideoRunner(cfg, seed=11, device="cpu")
    model = runner.create_video_model()
    p = seeded(model, 1)
    test = windows.windows(4, 9, seed=5)
    runner.set_data(None, VideoDataset(test["poses_3d"], test["poses_2d_gmm"], test["action_ids"],
                                       ACTIONS))
    seq = make_skip_sequence("uniform", 2, 24)
    step = runner._get_eval_fn(seq)
    runner.evaluate(is_train=True)
    batch = next(runner._make_loader(runner.test_data, shuffle=False, keyed=False).epoch(0))
    p1, p2, pred = step(runner.state, batch)
    want = ref.eval_batch(p, test, protocol.batch_rows(0, 2, 4),
                          dict(depth=2, heads=4, ln_eps=1e-6, test_times=3, seq=list(seq),
                               betas=protocol.linear_betas(1e-4, 1e-3, 51), loader_seed=11,
                               windows=2), "cpu")
    scale = np.abs(want["pred"]).max()
    np.testing.assert_allclose(pred.double().numpy(), want["pred"], rtol=0, atol=1e-5 * scale)
    np.testing.assert_allclose(p1.double().numpy(), want["p1"], rtol=0, atol=1e-6)
    # the program's P-MPJPE is a float32 quaternion solve (PERF.md §7, first)
    np.testing.assert_allclose(p2.double().numpy(), want["p2"], rtol=0, atol=1e-5)
    assert pred.shape == (2, 9, 17, 3) and p1.shape == p2.shape == (2, 9)


@pytest.mark.parametrize("name,impl", [("denoiser_impl", "fused"), ("denoiser_impl", "fused_st"),
                                       ("denoiser_impl", "fused_full"), ("train_impl", "fused"),
                                       ("train_impl", "plain")])
def test_fused_impls_refuse_it(name, impl):
    with pytest.raises(ValueError, match=rf"--{name} {impl}: .*MixSTE denoiser \(embed 32, "
                                         r"depth 2, 4 heads, MLP ratio 2.0\)"):
        VideoRunner(tiny_config(), device="cpu", **{name: impl})


def test_module_train_step_checkpoint_and_ema(tmp_path):
    """One epoch of the module train step (finite loss), its checkpoint loaded
    strictly by a second runner, and the EMA shadow over MixSTE's names."""
    cfg = tiny_config()
    cfg.training.n_epochs, cfg.optim.lr = 1, 1e-3
    runner = VideoRunner(cfg, seed=3, device="cpu", log_dir=str(tmp_path))
    model = runner.create_video_model()
    before = {k: v.clone() for k, v in model.state_dict().items()}
    runner.set_data(synthetic_video_dataset(4, 9, seed=2), None)
    history = runner.train()
    assert len(history["loss"]) == 1 and np.isfinite(history["loss"][0])
    assert set(runner.state.ema_params) == {k for k, _ in model.named_parameters()}
    assert any(not torch.equal(before[k], v) for k, v in model.state_dict().items())
    ckpt = tmp_path / "ckpt_00000002.pth"
    assert "TTEblocks.1.attn.qkv.weight" in load_torch_states(str(ckpt))[0]
    again = VideoRunner(cfg, seed=4, device="cpu").create_video_model(str(ckpt))
    assert all(torch.equal(v, again.state_dict()[k]) for k, v in model.state_dict().items())


def test_parameter_count_at_the_published_widths():
    """MixSTE2 at ``-f 243 -cs 512 -dep 8``, 2 channels in and 3 out, holds
    33,783,811 parameters; the configuration's denoiser adds uvxyz's channels
    and the timestep MLP (512·2048 + 2048 + 2048·512 + 512)."""
    x = tconfig.load_config(MIXSTE).mixste
    with torch.device("meta"):
        bare = MixSTE(243, coords_in=2, coords_out=3)
        full = MixSTE(243, coords_in=5, coords_out=5, embed_dim=x.embed_dim, depth=x.depth,
                      num_heads=x.num_heads, mlp_ratio=x.mlp_ratio, qkv_bias=x.qkv_bias,
                      ln_eps=x.ln_eps)
    assert sum(v.numel() for k, v in bare.named_parameters() if not k.startswith("temb")) == 33_783_811
    assert sum(v.numel() for v in full.parameters()) == 33_783_811 + 3 * 512 + 2 * 513 + 2_099_712


def test_port_config_round_trips(tmp_path):
    cfg = tconfig.load_config(MIXSTE)
    assert cfg.mixste == tconfig.MixSTEConfig()
    assert (cfg.video.frames, cfg.video.eval_stride, cfg.testing.test_num_diffusion_timesteps) == (243, 243, 24)
    out = tconfig.config_to_dict(cfg)
    assert out["mixste"]["embed_dim"] == 512 and out["mixste"]["ln_eps"] == 1e-6
    tconfig.save_config(cfg, str(tmp_path / "config.yml"))
    assert tconfig.config_to_dict(tconfig.load_config(str(tmp_path / "config.yml"))) == out
    assert "mixste" not in tconfig.config_to_dict(tconfig.load_config("configs/human36m_video.yml"))


def test_cli_evaluates_the_configuration_on_cpu(tmp_path, monkeypatch):
    """``main_video`` on the port's MixSTE file at its widths, over 9-frame
    windows: an eval-only run of one synthetic window."""
    built = []
    create = VideoRunner.create_video_model
    monkeypatch.setattr(VideoRunner, "create_video_model",
                        lambda self, path=None: built.append(create(self, path)) or built[-1])
    args = ["--config", MIXSTE, "--exp", str(tmp_path), "--doc", "ev", "--ni", "--frames", "9",
            "--synthetic_windows", "4", "--batch_size", "1", "--device", "cpu", "--track_metrics"]
    assert main_video.main(args) == 0
    log = (tmp_path / "ev" / "stdout.txt").read_text()
    assert re.search(r"Final \| MPJPE: [0-9.]+ mm \| P-MPJPE: [0-9.]+ mm", log)
    assert "throughput: {" in log
    assert "testing windows: 1 × 9 frames" in log
    (model,) = built
    assert isinstance(model, MixSTE) and (model.embed_dim, model.depth, model.num_heads) == (512, 8, 8)
    assert model.STEblocks[0].mlp.fc1.out_features == 1024 and model.temporal_paths["materialised"] == 16
