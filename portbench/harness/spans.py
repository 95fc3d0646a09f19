"""The program's spans in a profiled slice, and what they say about each layer.

``diffpose_tpu_torch/utils/profiling.py`` opens a span (``span(name)``) at
each layer boundary of the eval path; under the slice's profiler each one is
a host record among ``Slice.host_ops``, on the clock of the device records.
This module keeps the records whose names ``SPANS`` lists, and of those only
the whole ones.  The harness starts and stops the slice just after an eval
step returns, so the slice's extent here runs from its first record to the
end of its last ``step.eval`` span, and holds one whole ``step.eval`` a
batch; the readers give their numbers a batch, over that count.  A span
open when the profiler started was never recorded; one open when it
stopped (``runner.batch``) is either missing (the CUDA build's profiler
drops it) or stamped with the stop's instant as its end, past the extent,
and is left out.

All spans run on the one host thread, so containment is nesting: a span's
self time is its duration less the part its child spans cover, and the
device's idle time (the slice's extent less the union of its device records)
is split by the innermost span open during it.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

PER_BATCH = "step.eval"


class Span(NamedTuple):
    name: str
    start: int        # ns, the profiler's clock
    end: int


def span_names() -> frozenset:
    """The names the program's ``SPANS`` lists; empty for a program that has
    none (then every reader here reads None)."""
    try:
        from diffpose_tpu_torch.utils.profiling import SPANS
    except ImportError:
        return frozenset()
    return frozenset(s[0] for s in SPANS)


def extent(slice_) -> Optional[Tuple[int, int]]:
    """The slice's first instant over all of its records, and the end of
    its last ``step.eval`` span (without one, of its last record)."""
    records = list(slice_.host_ops) + list(slice_.device_events)
    if not records:
        return None
    steps = [e for n, _, e in slice_.host_ops if n == PER_BATCH]
    return min(r[1] for r in records), max(steps) if steps else max(r[2] for r in records)


def whole_spans(records: Sequence[Tuple[str, int, int]], names, lo: int, hi: int) -> List[Span]:
    """The records named in ``names`` lying wholly inside ``[lo, hi]``, in
    order of start (outer before inner at a tie)."""
    out = [Span(n, s, e) for n, s, e in records if n in names and lo <= s <= e <= hi]
    return sorted(out, key=lambda sp: (sp.start, -sp.end))


def self_segments(spans: Sequence[Span]) -> List[Span]:
    """Each span's stretches with no child span open, as ``Span`` pieces in
    order: they partition the time the spans cover, and the innermost span
    open at an instant is the piece that holds it.  ``spans`` as
    :func:`whole_spans` orders them."""
    out: List[Span] = []
    stack: List[list] = []          # [span, where its uncovered stretch resumes]

    def close_until(t):
        while stack and stack[-1][0].end <= t:
            sp, at = stack.pop()
            if sp.end > at:
                out.append(Span(sp.name, at, sp.end))
            if stack:
                stack[-1][1] = sp.end

    for sp in spans:
        close_until(sp.start)
        if stack:
            parent = stack[-1]
            if sp.start > parent[1]:
                out.append(Span(parent[0].name, parent[1], sp.start))
            parent[1] = sp.end       # a child ends inside its parent on one thread
        stack.append([sp, sp.start])
    close_until(float("inf"))
    return sorted(out, key=lambda p: p.start)


def self_times(spans: Sequence[Span]) -> Dict[str, int]:
    """Self time (ns) summed by name."""
    total: Dict[str, int] = {}
    for p in self_segments(spans):
        total[p.name] = total.get(p.name, 0) + p.end - p.start
    return total


def idle_intervals(busy: Sequence[Tuple[int, int]], lo: int, hi: int) -> List[Tuple[int, int]]:
    """``[lo, hi)`` less the sorted, disjoint ``busy`` intervals."""
    out, at = [], lo
    for s, e in busy:
        if s > at:
            out.append((at, min(s, hi)))
        at = max(at, e)
        if at >= hi:
            break
    if at < hi:
        out.append((at, hi))
    return [(s, e) for s, e in out if e > s]


def idle_by_span(spans: Sequence[Span], idle: Sequence[Tuple[int, int]]) -> Dict[Optional[str], int]:
    """The idle time (ns) split by the innermost span open during it; None
    holds the idle time with no span open."""
    pieces = self_segments(spans)
    out: Dict[Optional[str], int] = {}
    i = 0
    for s, e in idle:
        covered = 0
        while i < len(pieces) and pieces[i].end <= s:
            i += 1
        j = i
        while j < len(pieces) and pieces[j].start < e:
            part = min(e, pieces[j].end) - max(s, pieces[j].start)
            if part > 0:
                out[pieces[j].name] = out.get(pieces[j].name, 0) + part
                covered += part
            j += 1
        out[None] = out.get(None, 0) + (e - s - covered)
    return out


class SliceSpans(NamedTuple):
    spans: List[Span]
    batches: int              # whole step.eval spans
    lo: int
    hi: int


def of(slice_) -> Optional[SliceSpans]:
    """The slice's whole program spans and its batch count, or None where
    the program opened no whole ``step.eval`` span in it."""
    if slice_ is None:
        return None
    names, edges = span_names(), extent(slice_)
    if not names or edges is None:
        return None
    spans = whole_spans(slice_.host_ops, names, *edges)
    batches = sum(sp.name == PER_BATCH for sp in spans)
    return SliceSpans(spans, batches, *edges) if batches else None


def self_ms_per_batch(slice_, names: Sequence[str]) -> Optional[float]:
    """The self times of the spans ``names`` summed, ms a batch."""
    got = of(slice_)
    if got is None:
        return None
    times = self_times(got.spans)
    return 1e-6 * sum(times.get(n, 0) for n in names) / got.batches


def idle_ms_per_batch(slice_) -> Optional[Dict[Optional[str], float]]:
    """The device's idle time a batch (ms) by innermost span (None: no span
    open), or None where the slice has no device records or no spans."""
    got = of(slice_)
    if got is None or not slice_.device_events:
        return None
    idle = idle_intervals(slice_.busy_intervals(), got.lo, got.hi)
    return {k: 1e-6 * v / got.batches for k, v in idle_by_span(got.spans, idle).items()}
