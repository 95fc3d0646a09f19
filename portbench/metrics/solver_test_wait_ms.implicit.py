"""solver_test_wait_ms.implicit: the self time of the program's
``solver.test`` spans (the host reading the convergence test, which waits on
the device for the body's work), ms a batch of the profiled slice
(``harness/spans.py``)."""

from portbench.harness import spans


def read(run):
    return spans.self_ms_per_batch(run.slice, ["solver.test"])
