"""sync_wait_ms.eval: the self time of the program's ``runner.sync`` span,
the host waiting on the device once a group of batches, ms a batch of the
profiled slice (``harness/spans.py``).  The profiler's host work stretches
the slice, so the host reaches the wait later than in an untraced window and
this reads below what it waits there."""

from portbench.harness import spans


def read(run):
    return spans.self_ms_per_batch(run.slice, ["runner.sync"])
