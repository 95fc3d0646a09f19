"""metric_ms.eval: the program's per-sample MPJPE and P-MPJPE
(``diffpose_tpu_torch/metrics.py``) at the cell's eval batch shape on the
device, timed after the window by
the host clock over 100 calls, synchronised: ms a batch."""

import time

import torch

CALLS = 100


def read(run):
    from diffpose_tpu_torch.metrics import mpjpe_per_sample, p_mpjpe_per_sample

    sh, dev = run.session.shapes, run.ctx.device
    rows = sh["batch"]
    gen = torch.Generator(device=dev).manual_seed(run.ctx.seed)
    pred, target = torch.randn((2, rows, 17, 3), generator=gen, device=dev).unbind(0)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    for _ in range(3):
        mpjpe_per_sample(pred, target), p_mpjpe_per_sample(pred, target)
    sync()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        mpjpe_per_sample(pred, target), p_mpjpe_per_sample(pred, target)
    sync()
    return 1e3 * (time.perf_counter() - t0) / CALLS
