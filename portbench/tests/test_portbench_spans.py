"""``harness/spans.py`` and the readers that use it: on hand-made records
(self times under nesting, spans cut by the slice's edges, idle time by
innermost span, the per-batch normalisation) and on a traced tiny
frame-eval-h5 run on the CPU."""

from types import SimpleNamespace

import pytest

from portbench.harness import core, spans
from portbench.harness.trace import Slice

BENCH = core.BENCH_DIR
MS = 1_000_000          # ns


def fake_slice(host, device=()):
    s = Slice.__new__(Slice)
    s.host_ops, s.device_events = list(host), list(device)
    return s


def batch_records(t0):
    """One batch's spans from ``t0`` (ms): the loader, then the runner's
    group around a step with two DDIM steps, its errors, the wait and the
    fold; an operator inside the step."""
    b = t0 * MS
    return [
        ("loader.batch", b, b + 1 * MS),
        ("runner.batch", b + 2 * MS, b + 20 * MS),
        ("step.eval", b + 3 * MS, b + 12 * MS),
        ("aten::add", b + 4 * MS, b + 5 * MS),
        ("diffusion.step", b + 5 * MS, b + 7 * MS),
        ("diffusion.step", b + 7 * MS, b + 9 * MS),
        ("metrics.errors", b + 10 * MS, b + 11 * MS),
        ("runner.sync", b + 13 * MS, b + 17 * MS),
        ("metrics.accumulate", b + 18 * MS, b + 19 * MS),
    ]


def test_self_times_under_nesting():
    got = spans.whole_spans(batch_records(0), spans.span_names(), 0, 100 * MS)
    times = spans.self_times(got)
    assert times["runner.batch"] == (18 - 9 - 4 - 1) * MS      # less step, sync, fold
    assert times["step.eval"] == (9 - 4 - 1) * MS              # less 2 DDIM steps, errors
    assert times["diffusion.step"] == 4 * MS and times["loader.batch"] == 1 * MS
    assert "aten::add" not in times                             # operators are not spans
    pieces = spans.self_segments(got)
    assert sum(p.end - p.start for p in pieces) == 19 * MS     # the spans' cover, once
    assert all(a.end <= b.start for a, b in zip(pieces, pieces[1:]))


def test_spans_cut_by_the_slice_edges_are_left_out():
    """As the harness slices: it starts after a step returns (the tail of that
    batch's group is recorded, its runner.batch not) and stops after a step
    returns, with that batch's runner.batch open: the CPU build's profiler
    stamps it with the stop's instant, the CUDA build's drops it."""
    head = [("runner.sync", 0, 1 * MS), ("metrics.accumulate", 2 * MS, 3 * MS)]
    last = [("loader.batch", 26 * MS, 27 * MS), ("runner.batch", 28 * MS, 40 * MS),
            ("step.eval", 29 * MS, 35 * MS), ("aten::mul", 30 * MS, 31 * MS)]
    for stop_stamped in (True, False):
        recs = head + batch_records(5) + (last if stop_stamped else last[:1] + last[2:])
        s = fake_slice(recs, [("k", 30 * MS, 38 * MS)])
        lo, hi = spans.extent(s)
        assert (lo, hi) == (0, 35 * MS)                 # to the end of the last step
        got = spans.whole_spans(s.host_ops, spans.span_names(), lo, hi)
        count = {n: sum(sp.name == n for sp in got) for n in spans.span_names()}
        assert count["step.eval"] == 2 and count["runner.batch"] == 1
        assert count["runner.sync"] == 2 and count["loader.batch"] == 2
        # explicit edges: a span starting before lo is cut too
        inner = spans.whole_spans(s.host_ops, spans.span_names(), 1 * MS, hi)
        assert [sp for sp in got if sp.start >= 1 * MS] == inner and len(inner) == len(got) - 1


def test_idle_time_split_by_innermost_span():
    recs = batch_records(0)
    busy = [(4 * MS, 6 * MS), (8 * MS, 16 * MS)]
    idle = spans.idle_intervals(busy, 0, 21 * MS)
    assert idle == [(0, 4 * MS), (6 * MS, 8 * MS), (16 * MS, 21 * MS)]
    got = spans.idle_by_span(spans.whole_spans(recs, spans.span_names(), 0, 21 * MS), idle)
    assert got == {
        "loader.batch": 1 * MS,            # 0-1
        None: 1 * MS + 1 * MS,             # 1-2 and 20-21
        "runner.batch": 1 * MS + 1 * MS + 1 * MS,   # 2-3, 17-18, 19-20
        "step.eval": 1 * MS,               # 3-4
        "diffusion.step": 2 * MS,          # 6-8
        "runner.sync": 1 * MS,             # 16-17
        "metrics.accumulate": 1 * MS,      # 18-19
    }
    assert sum(got.values()) == sum(e - s for s, e in idle)


def test_per_batch_normalisation_and_the_readers():
    """Three batches as the harness slices them: the previous group's wait and
    fold first, the last batch's group cut after its step (CUDA build)."""
    head = [("runner.sync", -7 * MS, -3 * MS), ("metrics.accumulate", -2 * MS, -1 * MS)]
    last = [r for r in batch_records(40) if r[0] not in ("runner.batch", "runner.sync",
                                                         "metrics.accumulate")]
    recs = head + batch_records(0) + batch_records(20) + last
    device = [("k", -7 * MS, -4 * MS)] + [("k", (t + 4) * MS, (t + 16) * MS) for t in (0, 20, 40)]
    run = SimpleNamespace(slice=fake_slice(recs, device))
    read = {name: core.load_file(BENCH / "metrics" / f"{name}.py", f"t_{name}").read
            for name in ("loader_wait_ms.eval", "step_host_ms.eval", "metric_host_ms.eval",
                         "sync_wait_ms.eval", "idle_unspanned.eval")}
    got = spans.of(run.slice)
    assert got.batches == 3 and (got.lo, got.hi) == (-7 * MS, 52 * MS)
    assert read["loader_wait_ms.eval"](run) == pytest.approx(1.0)
    assert read["step_host_ms.eval"](run) == pytest.approx(4.0 + 4.0)
    assert read["metric_host_ms.eval"](run) == pytest.approx(1.0 + 1.0)
    assert read["sync_wait_ms.eval"](run) == pytest.approx(4.0)
    # idle: -4..4, 16..24, 36..44, 8 ms a batch; no span open -3..-2, -1..0, 1..2, 21..22,
    # 41..43 (the first and last group's runner.batch are not in the slice)
    by = spans.idle_ms_per_batch(run.slice)
    assert sum(by.values()) == pytest.approx(8.0) and by[None] == pytest.approx(2.0)
    assert by["runner.batch"] == pytest.approx(2.0) and by["loader.batch"] == pytest.approx(1.0)
    assert read["idle_unspanned.eval"](run) == pytest.approx(25.0)
    # a program without spans, or a slice without device records, reads None
    assert all(r(SimpleNamespace(slice=fake_slice([("aten::add", 0, 5)], device))) is None
               for r in read.values())
    assert read["idle_unspanned.eval"](SimpleNamespace(slice=fake_slice(recs))) is None


def test_traced_tiny_run_reports_the_span_readers():
    from portbench.tests.tiny import tiny_run

    res = tiny_run("frame-eval-h5", trace=True)
    m = res["metrics"]
    for name in ("loader_wait_ms.eval", "step_host_ms.eval", "metric_host_ms.eval",
                 "sync_wait_ms.eval"):
        assert m[name]["unit"] == "ms" and m[name]["value"] >= 0
    assert m["step_host_ms.eval"]["value"] > 0
    assert "idle_unspanned.eval" not in m          # no device records on the CPU
    assert res["correct"] is True
