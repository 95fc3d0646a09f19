"""idle_unspanned.eval: the share of the profiled slice's device-idle time
(its extent less the union of its device records) during which no program
span was open, in %.  Prints to standard error the idle time a batch by the
innermost span open during it, and each span's self time a batch beside
the slice's extent a batch (``harness/spans.py``).  Like ``idle.eval`` this
reads the profiled slice, which the profiler's host work stretches."""

import sys

from portbench.harness import spans


def read(run):
    idle = spans.idle_ms_per_batch(run.slice)
    if not idle:
        return None
    total = sum(idle.values())
    ranked = sorted(idle.items(), key=lambda kv: -kv[1])
    print("device idle a batch by innermost span (ms): " + ", ".join(
        f"{name or '(no span)'} {ms:.4f}" for name, ms in ranked), file=sys.stderr, flush=True)
    got = spans.of(run.slice)
    own = sorted(spans.self_times(got.spans).items(), key=lambda kv: -kv[1])
    print("self time a batch by span (ms): " + ", ".join(
        f"{name} {1e-6 * ns / got.batches:.4f}" for name, ns in own)
        + f"; their sum {1e-6 * sum(ns for _, ns in own) / got.batches:.4f} of the slice's extent "
        f"{1e-6 * (got.hi - got.lo) / got.batches:.4f} ms a batch over {got.batches} batches",
        file=sys.stderr, flush=True)
    return 100.0 * idle.get(None, 0.0) / total if total > 0 else None
