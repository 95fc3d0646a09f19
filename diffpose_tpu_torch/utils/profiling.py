"""Tracing: the program's spans and the profiler trace.

Counterpart of ``diffpose_tpu/utils/profiling.py`` (the reference's
``--track_metrics`` machinery, ``runners/diffpose_frame.py:52-57, 346-379,
422-461``).  The runners keep their own timing (``train/trainer.py``:
``train_seconds``, ``inference_times``, ``throughput_stats``); this module
holds what a ``torch.profiler`` session records of the program.

:func:`span` marks a stretch of the program's host work by name.  It records
only while a profiler session is active in the process (the benchmark's
profiled slice, :func:`trace_profile`, or any ``torch.profiler.profile``), as
a host record of that session: stamped on the clock of its operator and
device records, kept in the profiler's memory until the session is read or
exported.  Without a session it is one shared no-op, about half a
microsecond a call.  :data:`SPANS` lists every span the program opens.
"""

from __future__ import annotations

import contextlib
import os

import torch

# (name, layer, what one occurrence covers)
SPANS = (
    ("loader.batch", "loader",
     "BatchLoader.epoch: one batch built on the host (indices, seeds, the row gather)"),
    ("runner.prepare", "runner",
     "DiffposeRunner.evaluate (the frame and implicit families' one eval loop), "
     "VideoRunner.evaluate: the eval step's weights prepared once a call"),
    ("runner.batch", "runner",
     "DiffposeRunner.evaluate: one group of eval_sweep batches, enqueue to accumulate; "
     "VideoRunner.evaluate: one batch"),
    ("runner.sync", "runner",
     "DiffposeRunner.evaluate, VideoRunner.evaluate: the host waiting on the device once a group "
     "(video: a batch)"),
    ("runner.readback", "runner",
     "DiffposeRunner.evaluate, VideoRunner.evaluate: the group's per-sample (video: per-frame) "
     "errors copied to the host"),
    ("step.eval", "step",
     "make_eval_shell (make_eval_step, make_implicit_eval_step), make_video_eval_step: one eval "
     "batch enqueued, from its inputs to its errors (the implicit solve's reads of its bodies "
     "wait on the device inside it)"),
    ("step.inputs", "step",
     "make_eval_shell, make_video_eval_step: the batch's arrays copied to the device"),
    ("step.gmm", "step",
     "make_eval_shell, make_video_eval_step: the per-sample (video: per-frame) GMM kernel draw"),
    ("diffusion.step", "step",
     "ddim_sample: one DDIM step, the denoiser call and the update"),
    ("metrics.errors", "metrics",
     "make_eval_shell, make_video_eval_step: the batch's per-sample MPJPE and P-MPJPE"),
    ("solver.f", "solver",
     "solve_anderson, solve_damped: one evaluation of the fixed-point map f, enqueued"),
    ("solver.mix", "solver",
     "solve_anderson: one body's history update, Gram solve and mixing; solve_damped: one "
     "body's relaxation; enqueued"),
    ("solver.test", "solver",
     "solve_anderson (stopped): the host's read of a body's stall and, from min_iterations on, "
     "its convergence test, one a body; solve_damped: the read of the test, one a body from "
     "min_iterations on"),
    ("metrics.accumulate", "metrics",
     "ActionErrorAccumulator.add: one batch's errors folded on the host"),
    ("denoiser.spatial", "denoiser",
     "MixSTE.spatial: one spatial block and the shared Spatial_norm over [B*F, J, D], enqueued"),
    ("denoiser.temporal", "denoiser",
     "MixSTE.temporal: one temporal block and the shared Temporal_norm over [B*J, F, D], "
     "enqueued"),
)

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records ``name`` over its block while a profiler
    session is active, else the one shared no-op.

    The record is ``torch.profiler``'s fast host range (the kind that
    PyTorch's compiled graphs use): it costs about 3 us a call under the
    profiler against about 18 us for ``torch.profiler.record_function``, and
    unlike that one it adds no ``gpu_user_annotation`` records to the device
    side of the trace, so the device records stay the device's own work."""
    if not torch._C._autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(name)


@contextlib.contextmanager
def trace_profile(log_dir: str):
    """Capture a ``torch.profiler`` trace of the block (CPU, and CUDA where
    there is a card) into ``log_dir/trace.json``, a Chrome trace that
    Perfetto and ``chrome://tracing`` open; the program's spans are in it.
    Yields the profiler."""
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
