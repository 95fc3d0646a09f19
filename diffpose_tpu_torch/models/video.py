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

Dropout follows ``module.training``.

Context parallelism: ``cp_axis`` names a mesh axis that shards every
window's frames (``parallel/context.py``); it is a name, so the state dict
is the same with or without it.  :meth:`SpatioTemporalDiff.bind_mesh` hands
the module that axis of a ``DeviceMesh`` (its group, this rank's coordinate
and its size); the forward then takes this rank's block of ``F / size``
frames, adds the positional rows of that block and gathers the keys and
values of the whole window in each temporal block.  Unbound, or with
``cp_axis=None``, the module runs unsharded on whole windows.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from diffpose_tpu_torch.parallel.context import gather_frames
from diffpose_tpu_torch.parallel.mesh import MeshAxis, mesh_axis
from diffpose_tpu_torch.models.layers import (
    ChebGraphConv,
    GraAttenLayer,
    ResChebGCDiff,
    TorchDense,
    TorchStyleLayerNorm,
    chunked_attention,
    timestep_embedding,
)


def unsharded(name: Optional[str] = "context") -> MeshAxis:
    """The trivial axis: no group, coordinate 0, size 1."""
    return MeshAxis(name, None, 0, 1)


class TemporalAttention(nn.Module):
    """Multi-head attention over the frame axis of ``[N, F, D]`` rows.

    Under a bound context axis (``self.context``, set by
    :meth:`SpatioTemporalDiff.bind_mesh`) the queries stay on the rank and the
    keys and values are gathered over the axis (:func:`gather_frames`).  At
    or above ``attention_chunk`` gathered key frames (``> 0``) the eval path
    is :func:`chunked_attention`; training keeps the materialised scores,
    whose probabilities take the dropout
    (``diffpose_tpu/models/video.py:45-96``).
    """

    def __init__(self, dim: int, num_heads: int, dropout_rate: float = 0.1,
                 cp_axis: Optional[str] = None, attention_chunk: int = 256):
        super().__init__()
        self.cp_axis, self.context = cp_axis, unsharded(cp_axis)
        self.num_heads, self.attention_chunk = num_heads, attention_chunk
        self.q, self.k, self.v, self.out = (TorchDense(dim, dim) for _ in range(4))
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n, f, d = x.shape
        dk = d // self.num_heads

        def split(y):
            return y.reshape(n, y.shape[1], self.num_heads, dk).transpose(1, 2)

        k, v = self.k(x), self.v(x)
        if self.context.group is not None:    # keys and values side by side: one gather
            k, v = gather_frames(torch.cat([k, v], dim=-1), self.context).split(d, dim=-1)
        q, k, v = split(self.q(x)), split(k), split(v)
        if self.attention_chunk > 0 and k.shape[2] >= self.attention_chunk and not self.training:
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
        self.attn = TemporalAttention(dim_model, num_heads, dropout_rate, cp_axis,
                                      attention_chunk)
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

    ``cp_axis`` (a mesh axis name) reaches a ``DeviceMesh`` through
    :meth:`bind_mesh`, not through ``forward``: DDIM, the eval steps and
    autograd call the module as ``model(x, t, mask)`` and know nothing of
    the mesh, and a process group is neither a parameter nor a buffer, so
    the state dict stays the same.
    """

    def __init__(self, basis, frames: int, hid_dim: int = 96, coords_in: int = 5,
                 coords_out: int = 5, num_layers: int = 4, num_heads: int = 4,
                 dropout_rate: float = 0.1, n_pts: int = 17, cp_axis: Optional[str] = None,
                 attention_chunk: int = 256):
        super().__init__()
        self.cp_axis, self.context = cp_axis, unsharded(cp_axis)
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
                            TemporalBlock(hid_dim, num_heads, dropout_rate, cp_axis,
                                          attention_chunk))
        self.gconv_output = ChebGraphConv(hid_dim, coords_out, basis)

    def layer(self, i: int):
        """``(spatial_atten_i, spatial_res_i, temporal_i)``."""
        return (getattr(self, f"spatial_atten_{i}"), getattr(self, f"spatial_res_{i}"),
                getattr(self, f"temporal_{i}"))

    def bind_mesh(self, mesh) -> "SpatioTemporalDiff":
        """Shard the frames over ``mesh``'s ``cp_axis`` (this rank's coordinate
        and the axis's group, ``parallel.mesh.mesh_axis``); ``mesh=None``, a
        mesh without that axis or ``cp_axis=None`` unbinds."""
        axis = mesh_axis(mesh, self.cp_axis) if self.cp_axis else unsharded(self.cp_axis)
        self.context = axis
        for i in range(self.num_layers):
            self.layer(i)[2].attn.context = axis
        return self

    def frame_block(self, f_local: int) -> slice:
        """The window's frames this rank holds, given their count: all of them
        unsharded."""
        c = self.context
        if f_local * c.size != self.frames:
            raise ValueError(f"the model takes {self.frames}-frame windows; {f_local} frames a "
                             f"rank over {c.size} context ranks do not make one")
        return slice(c.index * f_local, (c.index + 1) * f_local)

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """ε̂ for noisy windows ``x`` [B, F_local, J, C] (this rank's frames of
        each window; all of them unsharded) at timesteps ``t`` [B]."""
        b, f, j, _ = x.shape
        pos = self.pos_embed[self.frame_block(f)]
        temb = timestep_embedding(t, self.hid_dim).to(x.dtype)
        temb = self.temb_dense_1(F.silu(self.temb_dense_0(temb)))
        temb_f = temb.repeat_interleave(f, dim=0)                 # [B·F, emd]

        h = self.gconv_input(x.reshape(b * f, j, -1)).reshape(b, f, j, self.hid_dim)
        h = h + pos[None, :, None, :]
        for i in range(self.num_layers):
            atten, res, temporal = self.layer(i)
            hs = res(atten(h.reshape(b * f, j, self.hid_dim), mask), temb_f)
            ht = hs.reshape(b, f, j, self.hid_dim).transpose(1, 2).reshape(b * j, f, self.hid_dim)
            h = temporal(ht).reshape(b, j, f, self.hid_dim).transpose(1, 2)
        out = self.gconv_output(h.reshape(b * f, j, self.hid_dim))
        return out.reshape(b, f, j, self.coords_out)
