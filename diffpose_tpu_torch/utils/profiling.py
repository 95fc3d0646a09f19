"""Performance tracking: wall-clock, throughput, device memory, profiler.

Counterpart of ``diffpose_tpu/utils/profiling.py`` (the reference's
``--track_metrics`` machinery, ``runners/diffpose_frame.py:52-57, 346-379,
422-461``): wall-clock bracketing that ends in ``torch.cuda.synchronize``
where the JAX version blocks on a result, device memory from
``torch.cuda.memory_allocated`` / ``max_memory_allocated``, and
``torch.profiler`` traces (CPU and CUDA activities) written as Chrome traces.
The runners keep their own timing (``train/trainer.py``: ``train_seconds``,
``inference_times``, ``throughput_stats``); this tracker is for scripts.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, List, Optional

import torch

from diffpose_tpu_torch.ops.fused_denoiser import resolve_device


def _synchronize(result) -> None:
    """Wait for the device work behind ``result`` (a tensor, or a tuple, list
    or dict of them); nothing for CPU tensors or ``None``."""
    if result is None:
        return
    if isinstance(result, dict):
        result = list(result.values())
    tensors = list(result) if isinstance(result, (list, tuple)) else [result]
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.device.type == "cuda":
            torch.cuda.synchronize(t.device)
            return


class MetricsTracker:
    def __init__(self):
        self.inference_times: List[float] = []
        self.memory_bytes: List[int] = []
        self.diffusion_step_count: int = 0
        self.fp_iteration_counts: List[int] = []
        self._t0: Optional[float] = None

    # -- timing --------------------------------------------------------

    @contextlib.contextmanager
    def time_block(self, result_to_block=None):
        t0 = time.perf_counter()
        yield
        _synchronize(result_to_block)
        self.inference_times.append(time.perf_counter() - t0)

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, result_to_block=None):
        _synchronize(result_to_block)
        assert self._t0 is not None
        self.inference_times.append(time.perf_counter() - self._t0)
        self._t0 = None

    # -- memory --------------------------------------------------------

    def record_memory(self, device="cuda"):
        """The bytes the caching allocator holds for tensors on ``device``, or
        its peak where none are held; ``device="cpu"`` has no device memory
        and records 0.  Without a card the default raises."""
        device = resolve_device(device)
        if device.type != "cuda":
            self.memory_bytes.append(0)
            return
        used = torch.cuda.memory_allocated(device) or torch.cuda.max_memory_allocated(device)
        self.memory_bytes.append(int(used))

    # -- summary -------------------------------------------------------

    def summary(self, frames_per_call: Optional[int] = None) -> Dict[str, float]:
        out: Dict[str, float] = {}
        if self.inference_times:
            total = sum(self.inference_times)
            out.update(
                time_avg=total / len(self.inference_times),
                time_min=min(self.inference_times),
                time_max=max(self.inference_times),
                time_total=total,
            )
            if frames_per_call:
                out["frames_per_second"] = frames_per_call * len(self.inference_times) / total
        if self.memory_bytes:
            out["memory_mb_peak"] = max(self.memory_bytes) / (1024 * 1024)
        if self.diffusion_step_count:
            out["diffusion_steps"] = self.diffusion_step_count
        if self.fp_iteration_counts:
            out["fp_iterations_mean"] = sum(self.fp_iteration_counts) / len(self.fp_iteration_counts)
        return out

    def write(self, path: str, frames_per_call: Optional[int] = None):
        """performance_metrics.txt-style dump (runners/diffpose_frame.py:452-461)."""
        s = self.summary(frames_per_call)
        with open(path, "w") as f:
            f.write("=== Performance Metrics ===\n")
            for k, v in s.items():
                f.write(f"{k}: {v:.4f}\n")
            f.write("\n=== Raw Data ===\n")
            f.write(f"Times: {self.inference_times}\n")
            f.write(f"Memory: {self.memory_bytes}\n")


@contextlib.contextmanager
def trace_profile(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (CPU, and CUDA where
    there is a card) into ``log_dir/trace.json``, a Chrome trace that
    Perfetto and ``chrome://tracing`` open.  Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.__enter__()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
