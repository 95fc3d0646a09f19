"""eval_kernels_roofline: the port's eval kernels in the profiled slice, the
least time of each launch (``counts.least_seconds`` of the work its shapes
need, counted once) summed, over their device time summed.  Launches are
matched by name; a lost record drops out of both sums."""

from portbench.harness import counts


def work(name: str, sh: dict):
    """(ops, bytes) of one launch of the kernel ``name`` in the cell, or None."""
    n = name.replace(" ", "")
    if sh["family"] == "frame":
        b = sh["batch"]
        if "net_forward_kernel<true,true" in n:          # row 1: the denoiser, every hypothesis
            w, rows = sh["denoiser"], b * sh["test_times"]
            return sum(counts.net_flops(w, rows)), counts.net_bytes(w, rows)
        if "net_forward_kernel<false,true" in n:         # row 2: the lifter
            return sum(counts.net_flops(sh["lifter"], b)), counts.net_bytes(sh["lifter"], b)
    return None


def read(run):
    if run.slice is None:
        return None
    least = spent = 0.0
    for name, start, end in run.slice.device_events:
        wb = work(name, run.session.shapes)
        if wb is not None and end > start:
            least += counts.least_seconds(*wb)
            spent += (end - start) * 1e-9
    return 100.0 * least / spent if spent > 0 else None
