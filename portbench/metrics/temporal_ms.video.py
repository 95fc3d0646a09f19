"""temporal_ms.video: the MixSTE denoiser's temporal blocks, each with its
shared ``Temporal_norm``, over the cell's window-hypotheses (``[B·J, F, D]``),
after the window: ms a call of all of them, CUDA events over 20 calls
(the driver's ``time_blocks``).  Beside ``spatial_ms.video`` it says which
half of a forward the time goes to."""


def read(run):
    time_blocks = getattr(run.session, "time_blocks", None)
    return time_blocks("temporal") if time_blocks else None
