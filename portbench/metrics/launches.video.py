"""launches.video: ``launches.eval``'s reading (device records in the
profiled slice over its batches) in the video cell."""

from portbench.harness import core

read = core.load_file(core.BENCH_DIR / "metrics" / "launches.eval.py",
                      "portbench_metric_launches.eval").read
