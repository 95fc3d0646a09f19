"""mfu.video: model operations of the batches the traced run's window
evaluated, over the window's seconds, over the dense TF32 peak
(``counts.PEAK_TF32``).  A batch: each DDIM step one MixSTE forward of every
hypothesis of every window, its matrix products counted once
(``harness/counts_video.py``)."""

from portbench.harness import counts, counts_video


def read(run):
    sh = run.session.shapes
    if sh.get("family") != "video" or not run.units or not run.window_s:
        return None
    per_batch = counts_video.batch_flops(sh["mix"], sh["batch"], sh["test_times"], sh["ddim_steps"])
    return 100.0 * run.units * per_batch / run.window_s / counts.PEAK_TF32
