"""implicit_kernels_roofline: kernel row 3 (``net_forward_kernel<true,false,…>``,
the IGCN's bare stack, once before the solve and once a body) in the profiled
slice: the least time of each launch (``counts.least_seconds`` of the work
its shapes need, counted once: ``harness/counts_implicit.py``) summed, over
their device time summed.  Launches are matched by name; a lost record drops
out of both sums."""

from portbench.harness import counts, counts_implicit


def read(run):
    sh = run.session.shapes
    if run.slice is None or sh["family"] != "implicit":
        return None
    w, rows = sh["denoiser"], sh["rows"]
    least_one = counts.least_seconds(counts_implicit.backbone_flops(w, rows),
                                     counts_implicit.backbone_bytes(w, rows))
    least = spent = 0.0
    for name, start, end in run.slice.device_events:
        if "net_forward_kernel<true,false" in name.replace(" ", "") and end > start:
            least += least_one
            spent += (end - start) * 1e-9
    return 100.0 * least / spent if spent > 0 else None
