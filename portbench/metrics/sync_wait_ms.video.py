"""sync_wait_ms.video: ``sync_wait_ms.eval``'s reading (the self time of the
program's ``runner.sync`` span, ms a batch of the profiled slice) in the
video cell, whose loop synchronises once a batch."""

from portbench.harness import core

read = core.load_file(core.BENCH_DIR / "metrics" / "sync_wait_ms.eval.py",
                      "portbench_metric_sync_wait_ms.eval").read
