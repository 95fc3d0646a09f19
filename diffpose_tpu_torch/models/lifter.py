"""GCNPose — the 2D→3D pose lifter that initializes the diffusion mean.

Same GraFormer backbone as :class:`GCNDiff` without timestep conditioning,
coords 2 → 3 (reference ``models/gcnpose.py:55-113``,
``runners/diffpose_frame.py:138``).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from diffpose_tpu_torch.models.layers import (
    ChebGraphConv,
    GraAttenLayer,
    ResChebGC,
    TimestepMLP,
)


class GCNPose(nn.Module):
    def __init__(self, basis, hid_dim: int = 96, coords_in: int = 2, coords_out: int = 3,
                 num_layers: int = 5, num_heads: int = 4, dropout_rate: float = 0.25,
                 n_pts: int = 17):
        super().__init__()
        self.hid_dim, self.num_layers, self.num_heads = hid_dim, num_layers, num_heads
        # Declared but unused, as in the reference (models/gcnpose.py:94-97),
        # so that a reference checkpoint loads strictly.
        self.temb = TimestepMLP(hid_dim, 4 * hid_dim)
        self.gconv_input = ChebGraphConv(coords_in, hid_dim, basis)
        self.atten_layers = nn.ModuleList(
            [GraAttenLayer(hid_dim, num_heads, n_pts, dropout_rate) for _ in range(num_layers)])
        self.gconv_layers = nn.ModuleList(
            [ResChebGC(hid_dim, hid_dim, basis, dropout_rate=0.1) for _ in range(num_layers)])
        self.gconv_output = ChebGraphConv(hid_dim, coords_out, basis)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        out = self.gconv_input(x)
        for atten, res in zip(self.atten_layers, self.gconv_layers):
            out = res(atten(out, mask))
        return self.gconv_output(out)
