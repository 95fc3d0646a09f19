"""step_host_ms.eval: the self times of the program's ``step.eval``,
``step.inputs``, ``step.gmm`` and ``diffusion.step`` spans summed: the eval
step's host time, its errors (``metrics.errors``) left out, ms a batch of
the profiled slice (``harness/spans.py``).  The profiler's host work
stretches the slice, so this reads above what an untraced window spends
there."""

from portbench.harness import spans


def read(run):
    return spans.self_ms_per_batch(run.slice, ["step.eval", "step.inputs", "step.gmm",
                                               "diffusion.step"])
