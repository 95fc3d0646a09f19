"""idle.eval: the share of the profiled slice's wall time in which nothing ran
on the device (one minus the union of its kernel, copy and set intervals over
its wall time).  The profiler's host work stretches the slice's batches, so
this reads above the idle share of an untraced window; it is the same share
that ``device.busy_s`` and ``device.window_s`` give."""


def read(run):
    s = run.slice
    busy = None if s is None else s.busy_s()
    if not busy or not s.wall_s:
        return None
    return 100.0 * (1.0 - busy / s.wall_s)
