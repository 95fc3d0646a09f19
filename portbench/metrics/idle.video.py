"""idle.video: ``idle.eval``'s reading (the share of the profiled slice's
wall time in which nothing ran on the device) in the video cell."""

from portbench.harness import core

read = core.load_file(core.BENCH_DIR / "metrics" / "idle.eval.py", "portbench_metric_idle.eval").read
