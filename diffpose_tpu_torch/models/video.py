"""SpatioTemporalDiff — the video (spatio-temporal) ε-prediction denoiser.

Counterpart of ``diffpose_tpu/models/video.py`` (the reference delegates
its 81/243-frame video models to an external project, ``README.md:92-93``,
so no reference ``.pth`` layout exists; the parameter names follow the
JAX package's tree, see ``models/convert.py:state_dict_from_flax_video``).

Per-frame ChebConv embedding plus a learned temporal positional embedding,
then ``num_layers`` alternations of

* a **spatial block**: the frame model's GraAttenLayer and
  timestep-injected ResChebGCDiff, per frame over the 17-joint graph, and
* a **temporal block**: pre-LN multi-head attention over the frame axis
  (per joint) and a pre-LN 2-layer feed-forward, both residual,

and a per-frame output ChebConv.  ``x`` is ``[B, F, J, C]``, ``t`` ``[B]``.

Dropout follows ``module.training``.  Context parallelism (``cp_axis``) has
no counterpart yet: constructing with one raises (ROADMAP queue 1 item 12).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from diffpose_tpu_torch.models.layers import (
    ChebGraphConv,
    GraAttenLayer,
    ResChebGCDiff,
    TorchDense,
    TorchStyleLayerNorm,
    chunked_attention,
    timestep_embedding,
)


def _no_context_axis(cp_axis):
    if cp_axis is not None:
        raise NotImplementedError(
            f"cp_axis={cp_axis!r}: context parallelism needs the torch.distributed port of "
            "diffpose_tpu/parallel (ROADMAP queue 1 item 12), which is not written yet")


class TemporalAttention(nn.Module):
    """Multi-head attention over the frame axis of ``[N, F, D]`` rows.

    At or above ``attention_chunk`` key frames (``> 0``) the eval path is
    :func:`chunked_attention`; training keeps the materialised scores, whose
    probabilities take the dropout (``diffpose_tpu/models/video.py:45-96``).
    """

    def __init__(self, dim: int, num_heads: int, dropout_rate: float = 0.1,
                 cp_axis: Optional[str] = None, attention_chunk: int = 256):
        super().__init__()
        _no_context_axis(cp_axis)
        self.num_heads, self.attention_chunk = num_heads, attention_chunk
        self.q, self.k, self.v, self.out = (TorchDense(dim, dim) for _ in range(4))
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, f, d = x.shape
        dk = d // self.num_heads

        def split(y):
            return y.reshape(n, f, self.num_heads, dk).transpose(1, 2)

        q, k, v = split(self.q(x)), split(self.k(x)), split(self.v(x))
        if self.attention_chunk > 0 and f >= self.attention_chunk and not self.training:
            out = chunked_attention(q, k, v, chunk_size=self.attention_chunk)
        else:
            probs = self.dropout(torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(dk), dim=-1))
            out = probs @ v
        return self.out(out.transpose(1, 2).reshape(n, f, d))


class TemporalBlock(nn.Module):
    """``x + drop(attn(norm1(x)))``, then ``x + drop(ff2(relu(ff1(norm2(x)))))``."""

    def __init__(self, dim_model: int, num_heads: int, dropout_rate: float = 0.1,
                 cp_axis: Optional[str] = None, attention_chunk: int = 256):
        super().__init__()
        self.attn = TemporalAttention(dim_model, num_heads, dropout_rate, cp_axis, attention_chunk)
        self.norm1 = TorchStyleLayerNorm(dim_model)
        self.norm2 = TorchStyleLayerNorm(dim_model)
        self.ff1 = TorchDense(dim_model, 2 * dim_model)
        self.ff2 = TorchDense(2 * dim_model, dim_model)
        self.drop_attn = nn.Dropout(dropout_rate)
        self.drop_ff = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.drop_attn(self.attn(self.norm1(x)))
        return x + self.drop_ff(self.ff2(F.relu(self.ff1(self.norm2(x)))))


class SpatioTemporalDiff(nn.Module):
    """Spatio-temporal ε-prediction denoiser over ``[B, F, J, C]`` windows.

    Submodules are named as the JAX package's parameter tree:
    ``temb_dense_{0,1}``, ``gconv_input``, ``pos_embed``,
    ``spatial_atten_{i}``, ``spatial_res_{i}``, ``temporal_{i}``,
    ``gconv_output``.
    """

    def __init__(self, basis, frames: int, hid_dim: int = 96, coords_in: int = 5,
                 coords_out: int = 5, num_layers: int = 4, num_heads: int = 4,
                 dropout_rate: float = 0.1, n_pts: int = 17, cp_axis: Optional[str] = None,
                 attention_chunk: int = 256):
        super().__init__()
        _no_context_axis(cp_axis)
        self.frames, self.hid_dim, self.num_layers = frames, hid_dim, num_layers
        self.num_heads, self.dropout_rate, self.n_pts = num_heads, dropout_rate, n_pts
        self.coords_out, self.attention_chunk = coords_out, attention_chunk
        emd_dim = 4 * hid_dim
        self.temb_dense_0 = TorchDense(hid_dim, emd_dim)
        self.temb_dense_1 = TorchDense(emd_dim, emd_dim)
        self.gconv_input = ChebGraphConv(coords_in, hid_dim, basis)
        self.pos_embed = nn.Parameter(torch.empty(frames, hid_dim))
        nn.init.normal_(self.pos_embed, std=0.02)
        for i in range(num_layers):
            self.add_module(f"spatial_atten_{i}",
                            GraAttenLayer(hid_dim, num_heads, n_pts, dropout_rate))
            # dropout 0.1 is fixed where the JAX module builds these blocks (video.py:186-188)
            self.add_module(f"spatial_res_{i}",
                            ResChebGCDiff(hid_dim, hid_dim, basis, emd_dim, dropout_rate=0.1))
            self.add_module(f"temporal_{i}",
                            TemporalBlock(hid_dim, num_heads, dropout_rate, None, attention_chunk))
        self.gconv_output = ChebGraphConv(hid_dim, coords_out, basis)

    def layer(self, i: int):
        """``(spatial_atten_i, spatial_res_i, temporal_i)``."""
        return (getattr(self, f"spatial_atten_{i}"), getattr(self, f"spatial_res_{i}"),
                getattr(self, f"temporal_{i}"))

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """ε̂ for noisy windows ``x`` [B, F, J, C] at timesteps ``t`` [B]."""
        b, f, j, _ = x.shape
        if f != self.frames:
            raise ValueError(f"the model takes {self.frames}-frame windows, got {f}")
        temb = timestep_embedding(t, self.hid_dim).to(x.dtype)
        temb = self.temb_dense_1(F.silu(self.temb_dense_0(temb)))
        temb_f = temb.repeat_interleave(f, dim=0)                 # [B·F, emd]

        h = self.gconv_input(x.reshape(b * f, j, -1)).reshape(b, f, j, self.hid_dim)
        h = h + self.pos_embed[None, :, None, :]
        for i in range(self.num_layers):
            atten, res, temporal = self.layer(i)
            hs = res(atten(h.reshape(b * f, j, self.hid_dim), mask), temb_f)
            ht = hs.reshape(b, f, j, self.hid_dim).transpose(1, 2).reshape(b * j, f, self.hid_dim)
            h = temporal(ht).reshape(b, j, f, self.hid_dim).transpose(1, 2)
        out = self.gconv_output(h.reshape(b * f, j, self.hid_dim))
        return out.reshape(b, f, j, self.coords_out)
