"""metric_host_ms.eval: the self times of the program's ``metrics.errors``
(per-sample MPJPE and P-MPJPE, enqueued in the eval step) and
``metrics.accumulate`` (``ActionErrorAccumulator.add`` on the host) spans
summed, ms a batch of the profiled slice (``harness/spans.py``).  The
profiler's host work stretches the slice, so this reads above what an
untraced window spends there."""

from portbench.harness import spans


def read(run):
    return spans.self_ms_per_batch(run.slice, ["metrics.errors", "metrics.accumulate"])
