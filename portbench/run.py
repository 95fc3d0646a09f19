"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload frame-eval-h5 --seed 7 --seconds 20 --trace 0

Everything a cell is lives in files: ``BENCHMARK.json`` names the cells and
metrics; ``portbench/workloads/<cell>.json`` gives the cell's configuration,
driver and sizes; ``portbench/configs/<config>.json`` the configuration as
it is run; ``portbench/drivers/<driver>.py`` drives one family's public
entry; ``portbench/metrics/<metric>.py`` reads one per-layer metric.

A run: set-up (import, kernel build on a checkout's first run, weights and
data from the seed, one warm-up pass), the measured window of
``--seconds``, with ``--trace 1`` a profiled slice of one more pass after
it and the per-layer readers, then the program's state is
freed and the plain reference in ``portbench/reference/`` checks a sample of
what the window produced.  The
numbers compared go to standard error beside their limits, and into the
result line, the last line of standard output.

``--control <tier>`` runs the program at a lower ``--kernel_precision``
tier (``default``: one TF32 pass; ``bf16``) for the check's control: its
``correct`` has to come out false.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time


def _process_age() -> float:
    """Seconds since this process started (Linux), else 0."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(uptime - start_ticks / os.sysconf("SC_CLK_TCK"), 0.0)
    except (OSError, ValueError, IndexError):
        return 0.0


T_START = time.perf_counter() - _process_age()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)
os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(ROOT, "build", "triton"))
os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(ROOT, "build", "torch_extensions"))
# One host thread for every CPU thread pool (torch's intra-op pool, the
# loader's OpenMP gather, BLAS), set before any of them loads: the eval loop
# is bound by one Python thread's launches, and idle pool threads spinning
# on the machine's few cores slow it by however the cores happen to be shared.
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("default", "bf16"), default=None,
                   help="run the program at this lower kernel tier (the check's control)")
    return p.parse_args(argv)


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device="cuda",
             control=None, cell_overrides=None, config_overrides=None, log=None,
             readings=False) -> dict:
    """One run of cell ``name``; returns the result line as a dict.
    ``device="cpu"`` and the overrides serve the CPU tests; ``readings`` adds
    every number the check computed, held or not, under ``readings``."""
    import torch

    from portbench.harness import core, trace as tracing
    from portbench.reference.check import verdict

    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    spec = core.spec()
    cell = core.load_json(core.BENCH_DIR / "workloads" / f"{name}.json")
    entry = next(w for w in spec["workloads"] if w["name"] == name)
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
            raise core.NoDevice(f"cell {name} needs {entry['chips']} CUDA device(s); "
                                f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        device = torch.device("cuda", 0)
    cell.update(cell_overrides or {})
    cfg_entry = next(c for c in spec["configs"] if c["name"] == cell["config"])
    config = core.load_json(core.ROOT / cfg_entry["file"])
    for key, value in (config_overrides or {}).items():
        if key == "config":
            for section, values in value.items():
                config["config"].setdefault(section, {}).update(values)
        else:
            config[key] = value
    ctx = core.Ctx(name=name, cell=cell, config=config, seed=seed, seconds=seconds, trace=trace,
                   device=device, kernel_precision=control or config["runner"]["kernel_precision"])
    driver = core.load_file(core.BENCH_DIR / "drivers" / f"{cell['driver']}.py",
                            f"portbench_driver_{cell['driver']}")

    session = driver.setup(ctx)
    setup_s = time.perf_counter() - T_START
    window = driver.window(session, seconds)
    log(f"window: {window['window_s']:.3f} s; its passes (s): "
        f"{[round(x, 3) for x in window['spans_s']]}")
    slice_ = None
    if trace:
        # after the window: on the card a profiler's stop slows every later
        # launch of the process, so a slice inside the window would bias it
        slice_ = tracing.Slice(device, cell["trace"]["units"])
        driver.profile(session, slice_)
        slice_.stop()
        slice_.collect()
    dev = core.device_info(device, entry["chips"])

    e2e = {m["name"]: m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])}
    values = dict(window["metrics"], setup_s=setup_s)
    metrics = {}
    if trace:
        run = core.Run(ctx, session, window["window_s"], window["frames"], window["units"], slice_)
        for m in spec["per_layer"]:
            if name not in m.get("workloads", [name]):
                continue
            reader = core.load_file(core.BENCH_DIR / "metrics" / f"{m['name']}.py",
                                    f"portbench_metric_{m['name']}")
            v = reader.read(run)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        busy = slice_.busy_s()
        dev.update(busy_s=busy if busy else 0.0, window_s=slice_.wall_s)
        log(f"traced run's window: {window['metrics']} over {window['window_s']} s; profiled "
            f"slice {slice_.wall_s} s, {slice_.units} units, the profiler's stop {slice_.stop_s} s")
    else:
        metrics = {k: {"value": values[k], "unit": e2e[k]["unit"]} for k in e2e if k in values}

    driver.release(session)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    numbers, limits, attempted, failed = driver.check(session)
    log(f"reference check: {time.perf_counter() - t_check:.2f} s")
    result = {"correct": verdict(numbers, limits), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": dev}
    if trace and slice_.device_events:
        result["breakdown"] = {"device_ops": slice_.device_ops(), "idle_gaps": slice_.idle_gaps()}
    result["checks"] = {k: {"value": numbers.get(k, float("nan")), "limit": limits[k]}
                        for k in limits}
    for k in limits:
        log(f"check {k} = {numbers.get(k, float('nan'))!r} limit {limits[k]!r}")
    if readings:
        result["readings"] = numbers
    return result


def main(argv=None) -> int:
    args = parse_args(argv)
    from portbench.harness import core

    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                          control=args.control)
    except core.NoDevice as e:
        print(f"error: {e}", file=sys.stderr)
        return 2
    found = core.forbidden_modules()
    if found:
        print(f"error: modules that the port must not load are loaded: {found}", file=sys.stderr)
        return 4
    checks = result.pop("checks")
    result["checks"] = checks         # the compared numbers come last in the line
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
