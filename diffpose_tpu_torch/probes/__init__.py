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


class ProfilerBlind(RuntimeError):
    """``torch.profiler`` is not trusted in this process: it recorded no
    kernel, or lost some of a trace's records."""


_sees_device = None


def profiler_sees_device(attempts: int = 3) -> bool:
    """Whether ``torch.profiler`` is trusted to time this process's kernels:
    first, whether a trace of one small kernel holds it (up to ``attempts``
    traces); later, whether every trace :func:`profiled` took held what it
    should."""
    global _sees_device
    if _sees_device is None:
        from torch.profiler import ProfilerActivity, profile

        lead = torch.zeros(1, device="cuda")
        _sees_device = False
        for _ in range(attempts):
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                lead.add_(1.0)
                torch.cuda.synchronize()
            if any(e.device_type.name == "CUDA" for e in prof.events()):
                _sees_device = True
                break
    return _sees_device


def device_clock() -> str:
    """The clock that :func:`device_ms` uses now in this process."""
    return "torch.profiler" if profiler_sees_device() else "CUDA events"


def profiled(fn, keep, want: int, cpu: bool = False) -> list:
    """The ``want`` events that ``keep`` selects from a ``torch.profiler``
    trace of one call of ``fn``, made after one untraced call; the trace
    starts with one small kernel of its own, so that the first of ``fn``'s
    kernels is not the trace's first.  The profiler on the card sometimes
    loses records, and a process whose traces lost some also mistimed the
    kernels they kept (PERF.md, PR 13); so a trace with other than ``want``
    makes the profiler untrusted for the rest of the process
    (:func:`profiler_sees_device`) and raises :class:`ProfilerBlind`, as
    does an untrusted profiler."""
    global _sees_device
    from torch.profiler import ProfilerActivity, profile

    if not profiler_sees_device():
        raise ProfilerBlind("torch.profiler is not trusted in this process")
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if cpu else [])
    fn()
    torch.cuda.synchronize()
    lead = torch.zeros(1, device="cuda")
    with profile(activities=activities) as prof:
        lead.add_(1.0)
        torch.cuda.synchronize()
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events() if keep(e)]
    if len(events) != want:
        _sees_device = False
        print(f"the profiler kept {len(events)} of {want} events; device times from here on "
              f"by CUDA events", flush=True)
        raise ProfilerBlind(f"torch.profiler kept {len(events)} of {want} events")
    return events


def device_ms(fn, kernel: str, reps: int = 20) -> float:
    """Mean device time of the kernels whose name holds ``kernel`` over
    ``reps`` calls of ``fn``, each launching one, from ``torch.profiler``
    (:func:`profiled`): the kernel alone, without the wrapper's host time
    that :func:`time_ms` includes where the kernel is short.  Where the
    profiler is not trusted in this process (:func:`device_clock`), it is
    :func:`time_ms` over ``reps`` calls, host gaps included."""
    def run():
        for _ in range(reps):
            fn()

    try:
        events = profiled(run, lambda e: e.device_type.name == "CUDA" and kernel in e.name, reps)
    except ProfilerBlind:
        return time_ms(fn, reps=reps)
    return sum(e.device_time_total for e in events) / 1e3 / reps
