"""loader_ms.eval: one pass of the runner's own eval loader alone (gather on
the host, each array the eval step reads copied to the device), no step,
timed after the window by the host clock and synchronised: ms a batch."""

import itertools
import time

import torch

KEYS = ("poses_3d", "poses_2d_gmm", "seeds")


def read(run):
    runner, dev = run.session.runner, run.ctx.device
    loader = runner._make_loader(runner.test_data, shuffle=False, keyed=False)
    n = min(len(loader), 128)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for batch in itertools.islice(loader.epoch(0), n):
        for k in KEYS:
            torch.as_tensor(batch[k], device=dev)
    sync()
    return 1e3 * (time.perf_counter() - t0) / n
