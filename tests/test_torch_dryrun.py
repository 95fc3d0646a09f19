"""The port's multi-rank dry run (diffpose_tpu_torch/dryrun.py) in one spawned
world of 2 CPU ranks over gloo: every parallel path of the three families,
the (1, 2) data x hypothesis and data x context meshes included, each held to
its single-process reference, ending in the JAX dry run's OK line."""

import re

from diffpose_tpu_torch.dryrun import dryrun_multichip


def test_dryrun_multichip_two_ranks_on_the_cpu(capsys):
    line = dryrun_multichip(2, device="cpu")
    assert capsys.readouterr().out.strip().splitlines()[-1] == line
    assert re.match(r"dryrun_multichip OK \(self-verified: .*\): 2 devices, train loss [0-9.]+, "
                    r"eval P1 [0-9.]+ mm, fused-kernel train loss [0-9.]+, implicit loss [0-9.]+, "
                    r"video loss [0-9.]+, video fused-train loss [0-9.]+, video P1 [0-9.]+ mm", line)
    assert "(video mesh (1, 2) data x context" in line
