"""MixSTE — the seq2seq mixed spatio-temporal transformer as a video
ε-prediction denoiser.

MixSTE (Zhang et al., "MixSTE: Seq2seq Mixed Spatio-Temporal Encoder for 3D
Human Pose Estimation in Video", CVPR 2022, arXiv 2203.00859;
``common/model_cross.py:MixSTE2`` of github.com/JinluZhang1126/MixSTE, run
there as ``-f 243 -cs 512 -dep 8``), the backbone of DiffPose's video
results, at any width, depth, heads, frames and joints.  Per window
``x [F, J, C]`` of width ``D``:

* embed: ``h = W_in·x + P_s[j] + temb(t)``;
* for ``i`` in ``0 … depth−1``: a spatial block over the ``J`` tokens of each
  frame, then ``Spatial_norm``; before the first temporal block
  ``h += P_t[f]``; a temporal block over the ``F`` tokens of each joint, then
  ``Temporal_norm`` (one norm of each kind, shared by every block of its
  kind);
* ``ε̂ = W_out·LN(h)`` (the head's LayerNorm keeps ``nn.LayerNorm``'s default
  eps, as MixSTE2's does).

A block is pre-LN (``nn.LayerNorm``, eps ``ln_eps``): ``h + attn(LN₁ h)``,
then ``h + mlp(LN₂ h)``; the attention has ``num_heads`` heads and a biased
``qkv`` projection, the MLP ``mlp_ratio·D`` hidden units and GELU.
Parameter names are MixSTE2's (``Spatial_patch_to_embedding``,
``STEblocks.{i}``, ``TTEblocks.{i}``, ``Spatial_norm``, …).

What DiffPose's use adds to MixSTE2, and what it leaves out: uvxyz channels
in and out (5 and 5 in the video family); the timestep MLP
(``timestep_embedding(t, D)`` → Linear ``D→4D`` → SiLU → Linear ``4D→D``),
added to every token with the spatial positional embedding; no stochastic
depth.  Dropout (``dropout_rate``, on the embeddings, the attention
probabilities and each block's outputs) follows ``module.training``.

The temporal attention runs :func:`chunked_attention` at or above
``attention_chunk`` key frames (``> 0``) in eval, else it materialises the
scores; ``temporal_paths`` counts its calls by path.  Each block call is a
program span, ``denoiser.spatial`` or ``denoiser.temporal``.
"""

from __future__ import annotations

import collections
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from diffpose_tpu_torch.models.layers import chunked_attention, timestep_embedding
from diffpose_tpu_torch.utils.profiling import span


class Attention(nn.Module):
    """Multi-head self-attention over the tokens of ``[N, S, D]`` rows; at or
    above ``chunk`` tokens (``> 0``) the eval path is query-chunked.  ``paths``
    (a ``Counter``, or None) counts the calls by path."""

    def __init__(self, dim: int, num_heads: int, qkv_bias: bool = True,
                 dropout_rate: float = 0.0, chunk: int = 0,
                 paths: Optional[collections.Counter] = None):
        super().__init__()
        self.num_heads, self.chunk, self.paths = num_heads, chunk, paths
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = nn.Linear(dim, 3 * dim, bias=qkv_bias)
        self.attn_drop = nn.Dropout(dropout_rate)
        self.proj = nn.Linear(dim, dim)
        self.proj_drop = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, s, d = x.shape
        q, k, v = self.qkv(x).reshape(n, s, 3, self.num_heads, d // self.num_heads).permute(
            2, 0, 3, 1, 4)
        if self.chunk > 0 and s >= self.chunk and not self.training:
            path = "chunked"
            out = chunked_attention(q, k, v, chunk_size=self.chunk, scale=self.scale)
        else:
            path = "materialised"
            out = self.attn_drop(torch.softmax((q @ k.transpose(-2, -1)) * self.scale, dim=-1)) @ v
        if self.paths is not None:
            self.paths[path] += 1
        return self.proj_drop(self.proj(out.transpose(1, 2).reshape(n, s, d)))


class Mlp(nn.Module):
    """``fc2(drop(gelu(fc1(x))))``, dropped."""

    def __init__(self, dim: int, hidden: int, dropout_rate: float = 0.0):
        super().__init__()
        self.fc1 = nn.Linear(dim, hidden)
        self.fc2 = nn.Linear(hidden, dim)
        self.drop = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.drop(self.fc2(self.drop(F.gelu(self.fc1(x)))))


class Block(nn.Module):
    """Pre-LN transformer block: ``x + attn(norm1(x))``, then ``x + mlp(norm2(x))``."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float, qkv_bias: bool,
                 ln_eps: float, dropout_rate: float, chunk: int = 0,
                 paths: Optional[collections.Counter] = None):
        super().__init__()
        self.norm1 = nn.LayerNorm(dim, eps=ln_eps)
        self.attn = Attention(dim, num_heads, qkv_bias, dropout_rate, chunk, paths)
        self.norm2 = nn.LayerNorm(dim, eps=ln_eps)
        self.mlp = Mlp(dim, int(dim * mlp_ratio), dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.norm1(x))
        return x + self.mlp(self.norm2(x))


class MixSTE(nn.Module):
    """MixSTE ε-prediction denoiser over ``[B, F, J, C]`` windows (the
    module's docstring)."""

    def __init__(self, frames: int, n_pts: int = 17, coords_in: int = 5, coords_out: int = 5,
                 embed_dim: int = 512, depth: int = 8, num_heads: int = 8,
                 mlp_ratio: float = 2.0, qkv_bias: bool = True, ln_eps: float = 1e-6,
                 dropout_rate: float = 0.0, attention_chunk: int = 256):
        super().__init__()
        self.frames, self.n_pts, self.embed_dim, self.depth = frames, n_pts, embed_dim, depth
        self.num_heads, self.dropout_rate, self.coords_out = num_heads, dropout_rate, coords_out
        self.temporal_paths: collections.Counter = collections.Counter()
        block = dict(dim=embed_dim, num_heads=num_heads, mlp_ratio=mlp_ratio, qkv_bias=qkv_bias,
                     ln_eps=ln_eps, dropout_rate=dropout_rate)
        self.Spatial_patch_to_embedding = nn.Linear(coords_in, embed_dim)
        self.Spatial_pos_embed = nn.Parameter(torch.zeros(1, n_pts, embed_dim))
        self.Temporal_pos_embed = nn.Parameter(torch.zeros(1, frames, embed_dim))
        self.temb_dense_0 = nn.Linear(embed_dim, 4 * embed_dim)
        self.temb_dense_1 = nn.Linear(4 * embed_dim, embed_dim)
        self.pos_drop = nn.Dropout(dropout_rate)
        self.STEblocks = nn.ModuleList(Block(**block) for _ in range(depth))
        self.TTEblocks = nn.ModuleList(Block(**block, chunk=attention_chunk,
                                             paths=self.temporal_paths) for _ in range(depth))
        self.Spatial_norm = nn.LayerNorm(embed_dim, eps=ln_eps)
        self.Temporal_norm = nn.LayerNorm(embed_dim, eps=ln_eps)
        self.head = nn.Sequential(nn.LayerNorm(embed_dim), nn.Linear(embed_dim, coords_out))

    def spatial(self, i: int, h: torch.Tensor) -> torch.Tensor:
        """Spatial block ``i`` and ``Spatial_norm`` over ``[B·F, J, D]``."""
        with span("denoiser.spatial"):
            return self.Spatial_norm(self.STEblocks[i](h))

    def temporal(self, i: int, h: torch.Tensor) -> torch.Tensor:
        """Temporal block ``i`` and ``Temporal_norm`` over ``[B·J, F, D]``."""
        with span("denoiser.temporal"):
            return self.Temporal_norm(self.TTEblocks[i](h))

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """ε̂ for noisy windows ``x [B, F, J, C]`` at timesteps ``t [B]``
        (``mask`` is the video family's call convention; every joint attends)."""
        b, f, j, _ = x.shape
        d = self.embed_dim
        if f != self.frames:
            raise ValueError(f"the model takes {self.frames}-frame windows, got {f}")
        temb = timestep_embedding(t, d).to(x.dtype)
        temb = self.temb_dense_1(F.silu(self.temb_dense_0(temb)))
        h = self.Spatial_patch_to_embedding(x) + self.Spatial_pos_embed + temb[:, None, None, :]
        h = self.pos_drop(h.reshape(b * f, j, d))
        for i in range(self.depth):
            h = self.spatial(i, h)
            h = h.reshape(b, f, j, d).transpose(1, 2).reshape(b * j, f, d)
            if i == 0:
                h = self.pos_drop(h + self.Temporal_pos_embed)
            h = self.temporal(i, h)
            h = h.reshape(b, j, f, d).transpose(1, 2).reshape(b * f, j, d)
        return self.head(h).reshape(b, f, j, self.coords_out)
