"""Capability and cost-split probes on the card (kernel rows 11 and 12).

Counterparts of the JAX package's ``scripts/probe_ablate.py`` and
``scripts/probe_batched_dot.py``: each holds a CUDA kernel, its launcher and
a plain PyTorch twin, and a ``run`` that measures on the card.  Nothing on a
main path calls them.  :func:`time_ms` is also ``chip_smoke.py``'s clock.
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
