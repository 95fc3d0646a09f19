"""solver_iters.implicit: the mean iterations (solver bodies) a solve over
the window's batches, from the count each eval step returned (a counter of
the program's; ``ImplicitRunner.fp_iterations`` logs the same counts)."""


def read(run):
    its = getattr(run.session, "window_iterations", None)
    return sum(its) / len(its) if its else None
