"""The measured window of an evaluation cell, shared by the eval drivers.

The window is whole passes of the runner's ``evaluate`` over the cell's
test split, the last one ending after ``seconds``; a traced run profiles a
slice of one more pass after it.  The runner's own eval step (built once,
kept in its cache) is wrapped so that the outputs of the sampled batches are
kept for the check and the profiled slice is started and counted; the
wrapper adds one Python call a batch and copies nothing.
"""

from __future__ import annotations

import time

import numpy as np

from portbench.reference import check as ref_check


class Capture:
    """The runner's eval step, keeping the outputs of batches ``picks`` (their
    index within a pass) while ``recording``."""

    def __init__(self, fn, per_pass: int, picks):
        self.fn, self.per_pass, self.picks = fn, per_pass, set(int(p) for p in picks)
        self.prepare = fn.prepare
        self.calls = 0
        self.recording = False
        self.kept = []                 # (batch index, (p1, p2, pred) as the step returned them)
        self.hook = None

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        index = self.calls % self.per_pass
        self.calls += 1
        if self.recording and index in self.picks:
            self.kept.append((index, out))
        if self.hook is not None:
            self.hook()
        return out


def picks(seed: int, per_pass: int, count: int) -> np.ndarray:
    """The batches whose outputs the check compares, drawn from the seed."""
    rng = np.random.default_rng([int(seed), 7])
    return np.sort(rng.choice(per_pass, size=min(count, per_pass), replace=False))


def run_window(runner, capture: Capture, seconds: float) -> dict:
    """Passes of ``runner.evaluate`` until ``seconds`` have gone by."""
    capture.recording = True
    times, frames, pass_s = [], 0, []
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        runner.evaluate(is_train=True)
        pass_s.append(time.perf_counter() - t)
        times.extend(runner.inference_times)
        frames += runner.eval_frames
        if time.perf_counter() - t0 >= seconds:
            break
    window_s = time.perf_counter() - t0
    capture.recording = False
    return {"window_s": window_s, "frames": frames, "units": len(times), "spans_s": pass_s,
            "metrics": {"eval_frames_per_s": frames / window_s,
                        "eval_batch_ms_p95": 1e3 * float(np.percentile(times, 95))}}


def profile_pass(runner, capture: Capture, slice_, start_at: int):
    """One more pass after the window, ``slice_`` profiling its batches from
    the ``start_at``-th on."""
    first = capture.calls

    def hook():
        if slice_.started:
            slice_.tick()
        elif capture.calls - first == start_at:
            slice_.start()

    capture.hook = hook
    runner.evaluate(is_train=True)
    capture.hook = None


def compare(kept, reference, limits) -> tuple:
    """The check of an eval cell: each kept ``(index, (p1, p2, pred))`` (host
    arrays) against ``reference(index)``'s ``{"pred", "p1", "p2"}``.
    Numbers: the pose's largest gap over the largest magnitude, the largest
    per-sample MPJPE gap, and the 99th percentile and the largest of the
    per-sample P-MPJPE gaps (mm); a cell holds those its limits name.
    Returns ``(numbers, failed batches)``."""
    refs, pose, p1_gap, p2_gaps, failed = {}, 0.0, 0.0, [], 0
    for index, (p1, p2, pred) in kept:
        if index not in refs:
            refs[index] = reference(index)
        ref = refs[index]
        got_pose = ref_check.max_rel(pred, ref["pred"])
        got_p1 = ref_check.max_abs_mm(p1, ref["p1"])
        gaps = 1000.0 * np.abs(p2 - ref["p2"]).ravel()
        got = {"pose_rel": got_pose, "p1_gap_mm": got_p1, "p2_gap_max_mm": float(gaps.max()),
               "p2_gap_q99_mm": float(np.percentile(gaps, 99))}
        failed += not ref_check.verdict(got, limits)
        pose, p1_gap = max(pose, got_pose), max(p1_gap, got_p1)
        p2_gaps.append(gaps)
    if not kept:
        return {}, 0
    p2_gaps = np.concatenate(p2_gaps)
    return {"pose_rel": pose, "p1_gap_mm": p1_gap, "p2_gap_max_mm": float(p2_gaps.max()),
            "p2_gap_q99_mm": float(np.percentile(p2_gaps, 99))}, failed
