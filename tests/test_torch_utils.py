"""The port's utilities (``diffpose_tpu_torch/utils``) against the JAX
package's (``diffpose_tpu/utils``): the memory-aware batch size, the
profiler trace with a program span in it, the pose animations (gif,
MJPEG-AVI without ffmpeg; mp4 and ``read_video`` of an mp4 where ffmpeg is
installed), as ``tests/test_memory_util.py`` and ``tests/test_utils.py``
hold the JAX ones.  The card's memory reads and trace run in chip_smoke.py
phase 34; the spans themselves in ``tests/test_torch_tracing.py``."""

import json
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from diffpose_tpu.utils import memory as jax_memory
from diffpose_tpu_torch.skeleton import Skeleton
from diffpose_tpu_torch.utils import span, trace_profile
from diffpose_tpu_torch.utils.memory import (
    DEFAULT_LIMIT,
    device_memory_budget,
    estimate_per_sample_bytes,
    suggest_batch_size,
)
from diffpose_tpu_torch.utils.visualization import read_video, render_animation, write_mjpeg_avi

SKELETON = Skeleton([-1, 0, 1, 0, 3], [1, 2], [3, 4])


def _animation_inputs(frames):
    kps = np.random.default_rng(0).uniform(0, 100, size=(frames, 5, 2))
    pose = np.random.default_rng(1).normal(size=(frames, 5, 3)) * 0.2
    return kps, {"ours": pose}


def _needs_ffmpeg():
    if shutil.which("ffmpeg") is None:
        pytest.skip("ffmpeg not available in this environment")


def test_budget_positive_and_the_cpu_default(monkeypatch):
    assert device_memory_budget("cpu", fraction=0.5) == DEFAULT_LIMIT // 2
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        device_memory_budget()                      # the card by default, and there is none


def test_suggest_batch_size_bounds_and_the_jax_functions():
    per_sample = estimate_per_sample_bytes()
    b = suggest_batch_size(per_sample, device="cpu")
    assert b % 8 == 0 and 8 <= b <= 65536
    assert suggest_batch_size(10 ** 12, device="cpu") == 8   # a tiny budget clamps at the minimum
    for kw in (dict(), dict(train=False, num_layers=4, hid_dim=128)):
        assert estimate_per_sample_bytes(**kw) == jax_memory.estimate_per_sample_bytes(**kw)
    # the same budget on a host without device statistics: the same batch
    assert suggest_batch_size(per_sample, device="cpu", fixed_bytes=2 ** 30) == \
        jax_memory.suggest_batch_size(per_sample, fixed_bytes=2 ** 30)


def test_trace_profile_writes_a_chrome_trace(tmp_path):
    """An operator's trace: a span opened inside ``trace_profile`` is in the
    exported Chrome trace, around the operators it holds."""
    with trace_profile(str(tmp_path / "trace")):
        with span("operator.block"):
            torch.ones(32, 32) @ torch.ones(32, 32)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())["traceEvents"]
    assert any("mm" in e.get("name", "") for e in trace)
    (block,) = [e for e in trace if e.get("name") == "operator.block"]
    (mm,) = [e for e in trace if e.get("name") == "aten::mm"]
    assert block["ts"] <= mm["ts"] and mm["ts"] + mm["dur"] <= block["ts"] + block["dur"]


def test_render_animation_gif(tmp_path):
    kps, poses = _animation_inputs(4)
    out = str(tmp_path / "anim.gif")
    render_animation(kps, poses, SKELETON, fps=5, bitrate=500, azim=70.0, output=out,
                     viewport=(100, 100), limit=3)
    assert os.path.getsize(out) > 0


def test_render_animation_mp4(tmp_path):
    """The mp4 writer path (reference visualization.py:129-131): needs ffmpeg."""
    _needs_ffmpeg()
    kps, poses = _animation_inputs(4)
    out = str(tmp_path / "anim.mp4")
    render_animation(kps, poses, SKELETON, fps=5, bitrate=500, azim=70.0, output=out,
                     viewport=(100, 100), limit=3)
    assert os.path.getsize(out) > 0


def test_read_video_roundtrip(tmp_path):
    """read_video through the ffmpeg pipe on an ffmpeg-made sample: needs ffmpeg."""
    _needs_ffmpeg()
    sample = str(tmp_path / "sample.mp4")
    subprocess.run(["ffmpeg", "-y", "-f", "lavfi", "-i", "testsrc=duration=1:size=64x48:rate=5",
                    sample], check=True, capture_output=True)
    frames = list(read_video(sample))
    assert len(frames) == 5
    assert frames[0].shape == (48, 64, 3) and frames[0].dtype == np.uint8


def test_mjpeg_avi_roundtrip(tmp_path):
    """The pure-Python MJPEG-AVI writer and reader, no ffmpeg needed."""
    yy, xx = np.mgrid[0:48, 0:64]
    frames = [np.stack([(xx * 4 + 10 * k) % 256, (yy * 5) % 256, np.full_like(xx, 40 * k)],
                       axis=-1).astype(np.uint8) for k in range(5)]
    out = str(tmp_path / "clip.avi")
    assert write_mjpeg_avi(out, frames, fps=10) == 5 and os.path.getsize(out) > 0
    back = list(read_video(out))
    assert len(back) == 5
    for orig, dec in zip(frames, back):
        assert dec.shape == orig.shape and dec.dtype == np.uint8
        assert np.abs(dec.astype(int) - orig.astype(int)).mean() < 8   # JPEG is lossy
    assert np.abs(back[0].astype(int) - back[4].astype(int)).mean() > 10
    assert len(list(read_video(out, skip=2))) == 3


def test_render_animation_avi(tmp_path):
    """render_animation → MJPEG AVI → read_video, without ffmpeg."""
    kps, poses = _animation_inputs(3)
    out = str(tmp_path / "anim.avi")
    render_animation(kps, poses, SKELETON, fps=5, bitrate=500, azim=70.0, output=out,
                     viewport=(100, 100), limit=3)
    decoded = list(read_video(out))
    assert len(decoded) == 3 and decoded[0].ndim == 3 and decoded[0].shape[2] == 3
