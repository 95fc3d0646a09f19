"""GCNDiff — the ε-prediction diffusion denoiser.

Reference ``models/gcndiff.py:55-113``: sinusoidal timestep embedding →
2-layer swish MLP (width 4·hid) → ChebConv(coords_in→hid) →
N×[GraAttenLayer → ResChebGCDiff(+temb)] → ChebConv(hid→coords_out), on
``[B, 17, 5]`` uvxyz tensors.  The ``state_dict`` uses the reference names.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from diffpose_tpu_torch.models.layers import (
    ChebGraphConv,
    GraAttenLayer,
    ResChebGCDiff,
    TimestepMLP,
)


class GCNDiff(nn.Module):
    def __init__(self, basis, hid_dim: int = 96, coords_in: int = 5, coords_out: int = 5,
                 num_layers: int = 5, num_heads: int = 4, dropout_rate: float = 0.25,
                 n_pts: int = 17):
        super().__init__()
        self.hid_dim, self.num_layers, self.num_heads = hid_dim, num_layers, num_heads
        # The reference overrides the config's emd_dim with 4·hid_dim
        # (models/gcndiff.py:68).
        emd_dim = 4 * hid_dim
        self.temb = TimestepMLP(hid_dim, emd_dim)
        self.gconv_input = ChebGraphConv(coords_in, hid_dim, basis)
        self.atten_layers = nn.ModuleList(
            [GraAttenLayer(hid_dim, num_heads, n_pts, dropout_rate) for _ in range(num_layers)])
        # dropout 0.1 is hardcoded where the reference builds these blocks (gcndiff.py:84)
        self.gconv_layers = nn.ModuleList(
            [ResChebGCDiff(hid_dim, hid_dim, basis, emd_dim, dropout_rate=0.1)
             for _ in range(num_layers)])
        self.gconv_output = ChebGraphConv(hid_dim, coords_out, basis)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """ε̂ for noisy ``x`` [B, n_pts, coords_in] at timesteps ``t`` [B];
        ``mask`` is an optional [1 or B, 1, n_pts] attention mask."""
        temb = self.temb(t)
        out = self.gconv_input(x)
        for atten, res in zip(self.atten_layers, self.gconv_layers):
            out = res(atten(out, mask), temb)
        return self.gconv_output(out)
