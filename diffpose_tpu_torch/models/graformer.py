"""Standalone GraFormer 2D→3D lifter (reference ``models/GraFormer.py:204-237``).

Counterpart of ``diffpose_tpu/models/graformer.py``: ChebConv-in →
``num_layers`` × [GraAttenLayer → ResChebGC] → ChebConv-out, on the
21-point ``GAN_EDGES`` graph by default.  Submodules carry the reference
names (``gconv_input``, ``atten_layers.{i}``, ``gconv_layers.{i}``,
``gconv_output``), so a reference checkpoint loads with ``strict=True``.

As in the reference, the residual blocks' dropout is fixed at 0.1 and the
attention's own dropout stays at 0.1; ``dropout_rate`` is that of the
attention layers' sublayers.  ``mask`` is ``[B, 1, N]``, 0 where a joint is
masked (its score is filled with −1e9).
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from diffpose_tpu_torch.models.layers import ChebGraphConv, GraAttenLayer, ResChebGC


class GraFormer(nn.Module):
    def __init__(self, basis, hid_dim: int = 128, coords_in: int = 2, coords_out: int = 3,
                 num_layers: int = 4, num_heads: int = 4, dropout_rate: float = 0.1,
                 n_pts: int = 21):
        super().__init__()
        self.hid_dim, self.num_layers, self.num_heads = hid_dim, num_layers, num_heads
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
