"""Cells at a size the CPU runs in seconds: the published widths, few rows."""

TINY_CONFIG = {"config": {"training": {"batch_size": 16}}, "test_frames": 48}
TINY_CELL = {"trace": {"start": 2, "units": 2}}


def tiny_run(name, seed=2**31 + 12345, *, trace=False, device="cpu", control=None):
    from portbench import run

    return run.run_cell(name, seed, 0.05, trace, device=device, control=control,
                        cell_overrides=TINY_CELL, config_overrides=TINY_CONFIG, log=lambda s: None)
