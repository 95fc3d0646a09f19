"""solver_mix_host_ms.implicit: the self time of the program's ``solver.mix``
spans (each Anderson body's history update, Gram solve and mixing, enqueued
on the host) summed, ms a batch of the profiled slice
(``harness/spans.py``).  The profiler's host work stretches the slice."""

from portbench.harness import spans


def read(run):
    return spans.self_ms_per_batch(run.slice, ["solver.mix"])
