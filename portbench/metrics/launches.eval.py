"""launches.eval: device records (kernels, copies, sets) in the profiled
slice over the eval batches it held."""


def read(run):
    s = run.slice
    if s is None or not s.units or not s.device_events:
        return None
    return len(s.device_events) / s.units
