"""The video cell's harness pieces on the CPU: its operation count against a
count of the model's matrix products from its shapes; a tiny run of
``video-mixste-eval-243`` (a MixSTE of width 32 and depth 2 over 9-frame
windows) that is correct, traced, with the cell's metrics; faults planted in
the program that the check must catch; and a program without the MixSTE
denoiser, which the driver refuses at once."""

import sys

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import run
from portbench.harness import counts_video

CELL = "video-mixste-eval-243"
TINY_CONFIG = {"config": {"mixste": {"embed_dim": 32, "depth": 2, "num_heads": 4},
                          "video": {"frames": 9, "eval_stride": 9},
                          "training": {"batch_size": 2}},
               "test_frames": 54}
TINY_CELL = {"trace": {"start": 1, "units": 1}}


def tiny_run(*, trace=False, device="cpu", control=None):
    return run.run_cell(CELL, 2**31 + 2323, 0.05, trace, device=device, control=control,
                        cell_overrides=TINY_CELL, config_overrides=TINY_CONFIG, log=lambda s: None)


@pytest.mark.parametrize("frames,dim,depth,heads,windows", [(9, 32, 2, 4, 3), (27, 64, 3, 8, 2)])
def test_counts_equal_the_models_products(frames, dim, depth, heads, windows):
    """``counts_video``'s operations equal the matrix products that one
    forward of the model runs (``FlopCounterMode``, from their shapes), and
    its weights the model's parameters."""
    from diffpose_tpu_torch.models.mixste import MixSTE

    model = MixSTE(frames, embed_dim=dim, depth=depth, num_heads=heads).eval()
    mix = counts_video.Mix(frames, 17, dim, depth, 2 * dim, 5, 5)
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        model(torch.randn(windows, frames, 17, 5), torch.ones(windows))
    assert fc.get_total_flops() == counts_video.forward_flops(mix, windows)
    blocks = sum(p.numel() for n, p in model.named_parameters() if n.startswith(("STE", "TTE")))
    assert blocks == 2 * depth * counts_video.block_weights(mix)
    assert sum(p.numel() for p in model.parameters()) - blocks == counts_video.end_weights(mix)
    assert counts_video.batch_flops(mix, windows, 5, 2) == 10 * counts_video.forward_flops(mix, windows)


def test_published_shape_counts():
    """The published shape's arithmetic at the cell's batch: 0.295 TFLOP a forward of a
    window, 20 window-hypotheses through 2 DDIM steps a batch."""
    mix = counts_video.Mix(243, 17, 512, 8, 1024, 5, 5)
    assert round(counts_video.forward_flops(mix, 1) / 1e9, 1) == 294.9
    assert round(counts_video.batch_flops(mix, 4, 5, 2) / 1e12, 2) == 11.79
    least = counts_video.batch_least_seconds(mix, 4, 5, 2)
    assert counts_video.batch_flops(mix, 4, 5, 2) / 495e12 < least < 1.05 * counts_video.batch_flops(mix, 4, 5, 2) / 495e12


def test_traced_tiny_run_is_correct_and_reports_the_cell():
    res = tiny_run(trace=True)
    m = res["metrics"]
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] == 3
    assert 0 < m["mfu.video"]["value"] < 100
    assert m["sync_wait_ms.video"]["value"] >= 0
    assert m["temporal_ms.video"]["value"] > 0 and m["spatial_ms.video"]["value"] > 0
    assert set(res["checks"]) == {"pose_rel", "p1_gap_mm", "p2_gap_q99_mm"}


def _plant(monkeypatch, fault):
    import diffpose_tpu_torch.train.video_steps as video_steps
    from diffpose_tpu_torch.models.mixste import MixSTE

    if fault == "temporal_pos_dropped":          # the forward leaves out P_t
        real = MixSTE.forward

        def planted(self, x, t, mask=None):
            saved = self.Temporal_pos_embed.data
            self.Temporal_pos_embed.data = torch.zeros_like(saved)
            try:
                return real(self, x, t, mask)
            finally:
                self.Temporal_pos_embed.data = saved
        monkeypatch.setattr(MixSTE, "forward", planted)
        return
    real = video_steps.ddim_sample
    if fault == "one_step_fewer":                # DDIM leaves out its first step
        def planted(denoise, x, seq, betas, **kw):
            return real(denoise, x, list(seq)[:-1], betas, **kw)
    else:                                        # half the hypotheses left at their start
        def planted(denoise, x, seq, betas, **kw):
            out = real(denoise, x, seq, betas, **kw)
            h = x.shape[0] // 2
            return torch.cat([out[:h], x[h:]])
    monkeypatch.setattr(video_steps, "ddim_sample", planted)


@pytest.mark.parametrize("fault", ["one_step_fewer", "half_unsolved", "temporal_pos_dropped"])
def test_fault_is_caught(monkeypatch, fault):
    _plant(monkeypatch, fault)
    assert tiny_run()["correct"] is False


def test_program_without_mixste_exits_at_set_up(monkeypatch):
    monkeypatch.setitem(sys.modules, "diffpose_tpu_torch.models.mixste", None)
    with pytest.raises(SystemExit, match="the program has no MixSTE denoiser"):
        tiny_run()


@pytest.mark.card
def test_control_fails_on_card(card):
    """The products at one TF32 pass (``--control default``) fail the check
    that the float32 products pass, on the card at a size a test holds."""
    assert tiny_run(device="cuda")["correct"] is True
    assert tiny_run(device="cuda", control="default")["correct"] is False
