"""The video family's spans on the CPU: one ``VideoRunner.evaluate`` of a tiny
MixSTE runner under ``torch.profiler`` records the runner's, the step's and
the denoiser's spans with the frame loop's nesting (``runner.batch`` around
the step, its sync and readback, the accumulator; ``step.eval`` around the
inputs, the GMM draw, each DDIM step and the errors; one
``denoiser.spatial`` and one ``denoiser.temporal`` a block call inside each
DDIM step), and the outputs are bit-equal with and without the profiler."""

import collections

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from diffpose_tpu_torch import config as tconfig
from diffpose_tpu_torch.data.video import synthetic_video_dataset
from diffpose_tpu_torch.diffusion import make_skip_sequence
from diffpose_tpu_torch.train.video_runner import VideoRunner
from diffpose_tpu_torch.utils import SPANS

torch.set_num_threads(1)

NAMES = {s[0] for s in SPANS}
SOLVER = {s[0] for s in SPANS if s[1] == "solver"}
PER_BATCH = {"loader.batch", "runner.batch", "runner.sync", "runner.readback", "step.eval",
             "step.inputs", "step.gmm", "metrics.errors", "metrics.accumulate"}


@pytest.fixture(scope="module")
def traced():
    cfg = tconfig.load_config("configs/torch/human36m_video_mixste.yml")
    cfg.mixste = tconfig.MixSTEConfig(embed_dim=32, depth=2, num_heads=4)
    cfg.video.frames = cfg.video.eval_stride = 9
    cfg.training.batch_size, cfg.testing.test_times = 2, 2
    runner = VideoRunner(cfg, seed=3, device="cpu")
    runner.create_video_model()
    runner.set_data(None, synthetic_video_dataset(6, 9, seed=1))
    plain = runner.evaluate(is_train=True)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        under = runner.evaluate(is_train=True)
    recs = [(e.name(), e.start_ns(), e.end_ns()) for e in prof.profiler.kineto_results.events()
            if e.name() in NAMES]
    return runner, recs, plain, under


def test_every_span_recorded_and_nested(traced):
    runner, recs, _, _ = traced
    count = collections.Counter(n for n, _, _ in recs)
    assert set(count) == NAMES - SOLVER
    batches = len(runner._make_loader(runner.test_data, shuffle=False, keyed=False))
    t = runner.config.testing
    steps = len(make_skip_sequence(runner.skip_type, t.test_timesteps, t.test_num_diffusion_timesteps))
    assert batches == 3 and count["runner.prepare"] == 1
    assert all(count[n] == batches for n in PER_BATCH)
    assert count["diffusion.step"] == batches * steps
    assert count["denoiser.spatial"] == count["denoiser.temporal"] == batches * steps * 2

    def by(name):
        return [(s, e) for n, s, e in recs if n == name]

    def inside(name, outer):
        return all(any(os <= s and e <= oe for os, oe in by(outer)) for s, e in by(name))

    for name, outer in (("step.eval", "runner.batch"), ("runner.sync", "runner.batch"),
                        ("runner.readback", "runner.batch"), ("metrics.accumulate", "runner.batch"),
                        ("step.inputs", "step.eval"), ("step.gmm", "step.eval"),
                        ("diffusion.step", "step.eval"), ("metrics.errors", "step.eval"),
                        ("denoiser.spatial", "diffusion.step"),
                        ("denoiser.temporal", "diffusion.step")):
        assert inside(name, outer), (name, outer)
    # the sync after the step, the readback after the sync, in every batch
    for (s0, e0), (s1, e1), (s2, _) in zip(by("step.eval"), by("runner.sync"), by("runner.readback")):
        assert e0 <= s1 and e1 <= s2
    # the loader's span is closed before its yield: outside every runner.batch
    assert all(e <= bs or be <= s for s, e in by("loader.batch") for bs, be in by("runner.batch"))


def test_outputs_bit_equal_under_the_profiler(traced):
    runner, _, plain, under = traced
    assert plain == under and np.isfinite(plain).all()
    assert runner.model.temporal_paths["materialised"] > 0 and "chunked" not in runner.model.temporal_paths
