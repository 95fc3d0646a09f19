"""loader_wait_ms.eval: the self time of the program's ``loader.batch`` span
(``BatchLoader.epoch`` building one batch on the host, where the runner
calls it), ms a batch of the profiled slice (``harness/spans.py``).  The
profiler's host work stretches the slice, so this reads above what an
untraced window spends there."""

from portbench.harness import spans


def read(run):
    return spans.self_ms_per_batch(run.slice, ["loader.batch"])
