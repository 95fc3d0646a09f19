"""mfu.implicit: model operations of the batches the traced run's window
evaluated, over the window's seconds, over the dense TF32 peak
(``counts.PEAK_TF32``).  A batch: the lifter once; on each of its ``B ×
test_times`` rows the timestep MLP, the two ChebConvs, and a stack and a plain
step for each solver body that moves ``z`` (``⌈iterations / m⌉``:
``harness/counts_implicit.py``), with each batch's own iteration count as the
window captured it."""

from portbench.harness import counts, counts_implicit


def read(run):
    sh = run.session.shapes
    its = getattr(run.session, "window_iterations", None)
    if sh["family"] != "implicit" or not its:
        return None
    total = sum(counts_implicit.eval_batch_flops(sh["denoiser"], sh["lifter"], sh["batch"],
                                                 sh["test_times"], k, sh["anderson_m"]) for k in its)
    return 100.0 * total / run.window_s / counts.PEAK_TF32
