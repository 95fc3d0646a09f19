"""A profiled slice of the measured window, and what it says about the device.

``Slice`` runs ``torch.profiler`` (host operators and device activity) over
a stretch of the window that the driver chooses, a few dozen batches or
steps, and keeps each device record (kernel, copy or set: name, start, end)
and each host operator.  The readers under ``metrics/`` take their numbers
from it.  ``torch.profiler`` now and then loses device records; nothing here
depends on an exact count of them.
"""

from __future__ import annotations

import time
from typing import List, Optional, Tuple

import torch

# Host records that are not operators: the runtime's calls and the profiler's own.
_NOT_OPERATORS = ("cuda", "Activity Buffer", "Runtime Triggered", "Lazy Function",
                  "ProfilerStep", "Memcpy", "Memset")


class Slice:
    """Profile from :meth:`start` to :meth:`stop`; ``units`` counts the batches
    or steps the driver ran in between."""

    def __init__(self, device: torch.device, want: int):
        self.device = device
        self.want = want            # batches or steps the driver should profile
        self.units = 0
        self.started = self.stopped = False
        self.wall_s = 0.0
        self.stop_s = 0.0
        self.device_events: List[Tuple[str, int, int]] = []   # (name, start ns, end ns)
        self.host_ops: List[Tuple[str, int, int]] = []
        self._prof = None
        self._t0 = 0.0

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def start(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self._sync()
        self._prof = profile(activities=acts)
        self._prof.start()
        self.started = True
        self._t0 = time.perf_counter()

    def tick(self):
        """One batch or step done; stops the profile after ``want`` of them."""
        if self.started and not self.stopped:
            self.units += 1
            if self.units >= self.want:
                self.stop()

    def stop(self):
        """Stop profiling; the records are read by :meth:`collect`, after the
        window, so that their reading costs the window nothing."""
        if not self.started or self.stopped:
            return
        self._sync()
        t = time.perf_counter()
        self.wall_s = t - self._t0
        self._prof.stop()
        self.stop_s = time.perf_counter() - t     # the profiler's own work, not the program's
        self.stopped = True

    def collect(self):
        if self._prof is None:
            return
        for e in self._prof.profiler.kineto_results.events():
            start, end = int(e.start_ns()), int(e.end_ns())
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                self.device_events.append((e.name(), start, end))
            elif not e.name().startswith(_NOT_OPERATORS):
                self.host_ops.append((e.name(), start, end))
        self._prof = None

    # ------------------------------------------------------------------

    def busy_intervals(self) -> List[Tuple[int, int]]:
        """The union of the device records' intervals, in order."""
        out: List[Tuple[int, int]] = []
        for _, s, e in sorted(self.device_events, key=lambda r: r[1]):
            if out and s <= out[-1][1]:
                out[-1] = (out[-1][0], max(out[-1][1], e))
            else:
                out.append((s, e))
        return out

    def busy_s(self) -> Optional[float]:
        iv = self.busy_intervals()
        return sum(e - s for s, e in iv) * 1e-9 if iv else None

    def device_ops(self, top: int = 10) -> list:
        """The device records' time summed by name, the largest ``top``."""
        total: dict = {}
        for name, s, e in self.device_events:
            total[name] = total.get(name, 0) + (e - s)
        ranked = sorted(total.items(), key=lambda kv: -kv[1])[:top]
        return [[_short(n), v * 1e-9] for n, v in ranked]

    def idle_gaps(self, top: int = 10) -> list:
        """The longest gaps between device work, each named by the innermost
        host operator that was running when the gap began."""
        iv = self.busy_intervals()
        gaps = sorted(((iv[i + 1][0] - iv[i][1], iv[i][1]) for i in range(len(iv) - 1)),
                      reverse=True)[:top]
        out = []
        for length, at in gaps:
            inside = [(e - s, n) for n, s, e in self.host_ops if s <= at < e]
            out.append([_short(min(inside)[1]) if inside else "host (no operator)", length * 1e-9])
        return out


def _short(name: str, limit: int = 96) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."
