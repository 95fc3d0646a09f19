"""The frame family's evaluation batch, in plain PyTorch.

``eval_batch``: lift with GCNpose, root-centre, replicate ``test_times``
hypotheses, DDIM over ``seq`` from the lifted uvxyz, hypothesis mean,
root-centre, per-sample MPJPE and P-MPJPE (``runners/diffpose_frame.py``'s
``test_hyber``), in float64 from the benchmark's float32 weights and data;
the GMM kernel draw is made as the program makes it (``protocol.py``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from portbench.reference import nets, protocol


def to64(params: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    return {k: v.detach().to(device=device, dtype=torch.float64) for k, v in params.items()}


def eval_batch(diff: dict, pose: dict, data: dict, rows: np.ndarray, cfg: dict, device) -> dict:
    """``diff``, ``pose``: float64 weights; ``data``: the split's arrays;
    ``rows``: the batch's dataset rows; ``cfg``: hid, layers, heads,
    test_times, seq, betas, loader_seed.  Returns pred ``[B, J, 3]`` and
    p1, p2 ``[B]`` (metres) as numpy float64."""
    basis = torch.as_tensor(cfg["basis"], dtype=torch.float64, device=device)
    gmm = torch.as_tensor(data["poses_2d_gmm"][rows], device=device)
    p3 = torch.as_tensor(data["poses_3d"][rows], device=device).double()
    ids = torch.as_tensor(protocol.sample_ids(rows, seed=cfg["loader_seed"]), device=device)
    uv, _ = protocol.gmm_kernels(gmm, protocol.gmm_choice_per_sample(0, ids, gmm))
    uv = uv.double()
    arch = dict(layers=cfg["layers"], heads=cfg["heads"])
    xyz = nets.gcn_pose(pose, uv, basis, **arch)
    xyz = xyz - xyz[:, :1]
    x = torch.cat([uv, xyz], dim=-1).repeat(cfg["test_times"], 1, 1)
    out = protocol.ddim(lambda z, t: nets.gcn_diff(diff, z, t, basis, hid=cfg["hid"], **arch),
                        x, cfg["seq"], cfg["betas"])
    out = out.reshape(cfg["test_times"], -1, *out.shape[1:]).mean(dim=0)
    pred = out[..., 2:] - out[:, :1, 2:]
    pred = pred.cpu().numpy()
    target = (p3 - p3[:, :1]).cpu().numpy()
    return dict(pred=pred, p1=protocol.mpjpe(pred, target), p2=protocol.p_mpjpe(pred, target))
