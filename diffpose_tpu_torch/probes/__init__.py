"""Capability and cost-split probes on the card (kernel rows 11 and 12).

Counterparts of the JAX package's ``scripts/probe_ablate.py`` and
``scripts/probe_batched_dot.py``: each holds a CUDA kernel, its launcher and
a plain PyTorch twin, and a ``run`` that measures on the card.  Nothing on a
main path calls them.  :func:`time_ms` and :func:`device_ms` are also
``chip_smoke.py``'s clocks.
"""

from __future__ import annotations

import statistics

import torch


def time_ms(fn, reps: int = 10, runs: int = 7) -> float:
    """Median over ``runs`` of the mean time of ``reps`` back-to-back calls,
    with CUDA events, after 3 warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / reps)
    return statistics.median(times)


def profiled(fn, keep, want: int, cpu: bool = False, attempts: int = 3) -> list:
    """The ``torch.profiler`` events that ``keep`` selects from a trace of
    one call of ``fn``, made after one untraced call.  The profiler now and
    then loses a kernel's record, so a trace that holds other than ``want``
    of them is taken again, up to ``attempts`` traces in all; if none holds
    ``want``, this raises.  Each trace starts with one small kernel of its
    own, so that the first of ``fn``'s kernels is not the trace's first."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    fn()
    torch.cuda.synchronize()
    lead = torch.zeros(1, device="cuda")
    seen = []
    for _ in range(attempts):
        with profile(activities=activities) as prof:
            lead.add_(1.0)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        events = [e for e in prof.events() if keep(e)]
        if len(events) == want:
            return events
        seen.append(len(events))
        print(f"the profiler kept {len(events)} of {want} events; trace taken again", flush=True)
    raise RuntimeError(f"the profiler saw {seen} events in {attempts} traces, not {want}")


def device_ms(fn, kernel: str, reps: int = 20) -> float:
    """Mean device time of the kernels whose name holds ``kernel`` over
    ``reps`` calls of ``fn``, each launching one, from ``torch.profiler``
    (:func:`profiled`): the kernel alone, without the wrapper's host time
    that :func:`time_ms` includes where the kernel is short."""
    def run():
        for _ in range(reps):
            fn()

    events = profiled(run, lambda e: e.device_type.name == "CUDA" and kernel in e.name, reps)
    return sum(e.device_time_total for e in events) / 1e3 / reps
