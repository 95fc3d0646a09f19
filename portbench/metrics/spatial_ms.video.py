"""spatial_ms.video: the MixSTE denoiser's spatial blocks, each with its
shared ``Spatial_norm``, over the cell's window-hypotheses (``[B·F, J, D]``),
after the window: ms a call of all of them, CUDA events over 20 calls (the
driver's ``time_blocks``)."""


def read(run):
    time_blocks = getattr(run.session, "time_blocks", None)
    return time_blocks("spatial") if time_blocks else None
