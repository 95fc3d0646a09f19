"""video_step_roofline: the least time of an eval batch's model work over the
device time a batch of the profiled slice (the union of its device records
over its batches).  The least time is the sum over each forward's pieces
(each block, the embedding and the head) of ``counts.least_seconds``: its
operations once at the TF32 peak, its bytes (weights once, activations in
and out) at HBM's (``harness/counts_video.py``).  No kernel of the port runs
this step: the share is the whole step's, its glue included."""

from portbench.harness import counts_video


def read(run):
    s, sh = run.slice, run.session.shapes
    if s is None or sh.get("family") != "video" or not s.units:
        return None
    busy = s.busy_s()
    if not busy:
        return None
    least = counts_video.batch_least_seconds(sh["mix"], sh["batch"], sh["test_times"],
                                             sh["ddim_steps"])
    return 100.0 * least * s.units / busy
