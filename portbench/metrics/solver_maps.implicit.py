"""solver_maps.implicit: the evaluations of the fixed-point map a batch, the
whole ``solver.f`` spans of the profiled slice over its ``step.eval`` spans
(``harness/spans.py``).  A program without the span reads nothing."""

from portbench.harness import spans


def read(run):
    got = spans.of(run.slice)
    if got is None or "solver.f" not in spans.span_names():
        return None
    return sum(sp.name == "solver.f" for sp in got.spans) / got.batches
