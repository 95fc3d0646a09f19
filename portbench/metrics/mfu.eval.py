"""mfu.eval: model operations of the frames the traced run's window lifted,
over the window's seconds, over the dense TF32 peak (counts.PEAK_TF32).
The lifter once and the denoiser at each DDIM step for each hypothesis,
counted once each, from the cell's shapes (``harness/counts.py``)."""

from portbench.harness import counts


def read(run):
    sh = run.session.shapes
    if sh["family"] != "frame":
        return None
    per = counts.frame_model_flops(sh["denoiser"], sh["lifter"], sh["ddim_steps"], sh["test_times"])
    return 100.0 * run.frames * per / run.window_s / counts.PEAK_TF32
