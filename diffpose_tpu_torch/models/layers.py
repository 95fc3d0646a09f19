"""Building blocks of the GraFormer-style networks, as torch modules.

Each module keeps the reference's parameter names and layouts, so a
reference ``state_dict`` loads strictly, and its numerics:

* :class:`ChebGraphConv` — ``Σ_k T_k(L)·X·W_k + b`` with the Chebyshev stack
  computed once on the host (the reference rebuilds it every forward,
  ``models/ChebConv.py:80-81``).
* :class:`TorchStyleLayerNorm` — ``a·(x−μ)/(σ+eps)+b`` with Bessel σ and eps
  outside the square root (``models/GraFormer.py:58-70``).
* :class:`MultiHeadAttention` — scaled dot-product attention over the
  joints, −1e9 mask fill, dropout on the probabilities.
* :class:`GraphNet` — learned-adjacency two-layer GCN, the "feed-forward"
  of each :class:`GraAttenLayer`.
* :class:`ResChebGCDiff` — two Chebyshev convs with the timestep embedding
  added between them (``models/gcndiff.py:39-53``); :class:`ChebNet`, two
  plain ones.
* :class:`PositionwiseFeedForward` — the transformer FFN the reference
  defines beside the attention.
* :func:`chunked_attention` — query-chunked attention for long temporal
  windows (the video family's beyond-threshold inference path).

Dropout follows ``module.training``; call ``.eval()`` for inference.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from diffpose_tpu_torch.graph import learned_adjacency_laplacian

# torch's Linear is the reference's dense layer: same [out, in] weight,
# same default init U(±1/√fan_in).
TorchDense = nn.Linear


class ChebGraphConv(nn.Module):
    """Chebyshev graph convolution with the reference's parameter layout:
    ``weight [K+1, 1, in, out]`` (Xavier-normal), ``bias [1, 1, out]``."""

    def __init__(self, in_features: int, out_features: int, basis):
        super().__init__()
        basis = torch.as_tensor(np.asarray(basis, np.float32))
        self.register_buffer("basis", basis, persistent=False)
        self.weight = nn.Parameter(torch.empty(basis.shape[0], 1, in_features, out_features))
        nn.init.xavier_normal_(self.weight)
        self.bias = nn.Parameter(torch.zeros(1, 1, out_features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xk = torch.einsum("knm,bmc->bnkc", self.basis.to(x.dtype), x)
        return torch.einsum("bnkc,kcd->bnd", xk, self.weight[:, 0]) + self.bias.reshape(-1)


class GraphConvBlock(nn.Module):
    """ChebConv + ReLU (+ dropout), reference ``_GraphConv``.

    With a dropout rate the reference applies ReLU, dropout, then ReLU again
    (``models/ChebConv.py:145-151``); the second ReLU is a no-op in eval
    but changes the dropout statistics in training.  With
    ``dropout_rate=None`` the block is ``relu(gconv(x))`` and has no
    dropout module.
    """

    def __init__(self, in_features: int, out_features: int, basis,
                 dropout_rate: Optional[float] = None):
        super().__init__()
        self.gconv = ChebGraphConv(in_features, out_features, basis)
        self.dropout = None if dropout_rate is None else nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.gconv(x)
        if self.dropout is not None:
            x = self.dropout(F.relu(x))
        return F.relu(x)


class ResChebGC(nn.Module):
    """Two-conv residual block (reference ``_ResChebGC``, ChebConv.py:154-165)."""

    def __init__(self, features: int, hid_dim: int, basis, dropout_rate: float = 0.1):
        super().__init__()
        self.gconv1 = GraphConvBlock(features, hid_dim, basis, dropout_rate)
        self.gconv2 = GraphConvBlock(hid_dim, features, basis, dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.gconv2(self.gconv1(x))


class ChebNet(nn.Module):
    """Plain two-conv graph net (reference ``ChebNet``, ChebConv.py:168-178):
    ``gconv2(gconv1(x))``, both :class:`GraphConvBlock`."""

    def __init__(self, in_features: int, features: int, hid_dim: int, basis,
                 dropout_rate: Optional[float] = None):
        super().__init__()
        self.gconv1 = GraphConvBlock(in_features, hid_dim, basis, dropout_rate)
        self.gconv2 = GraphConvBlock(hid_dim, features, basis, dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.gconv2(self.gconv1(x))


class ResChebGCDiff(nn.Module):
    """``x + gconv2(gconv1(x) + W_t·swish(temb))`` (reference
    ``models/gcndiff.py:39-53``): the projection is added after gconv1's
    ReLU."""

    def __init__(self, features: int, hid_dim: int, basis, emd_dim: int,
                 dropout_rate: float = 0.1):
        super().__init__()
        self.gconv1 = GraphConvBlock(features, hid_dim, basis, dropout_rate)
        self.gconv2 = GraphConvBlock(hid_dim, features, basis, dropout_rate)
        self.temb_proj = TorchDense(emd_dim, hid_dim)

    def forward(self, x: torch.Tensor, temb: torch.Tensor) -> torch.Tensor:
        out = self.gconv1(x)
        out = out + self.temb_proj(F.silu(temb))[:, None, :]
        return x + self.gconv2(out)


class TorchStyleLayerNorm(nn.Module):
    """``a_2·(x−μ)/(σ+eps)+b_2`` with Bessel-corrected σ (reference
    ``models/GraFormer.py:58-70``)."""

    def __init__(self, dim: int, eps: float = 1e-6):
        super().__init__()
        self.eps = eps
        self.a_2 = nn.Parameter(torch.ones(dim))
        self.b_2 = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(dim=-1, keepdim=True)
        centered = x - mean
        var = (centered * centered).sum(dim=-1, keepdim=True) / (x.shape[-1] - 1)
        return self.a_2 * centered / (torch.sqrt(var) + self.eps) + self.b_2


class MultiHeadAttention(nn.Module):
    """Scaled dot-product MHA over the joint axis (reference
    ``models/GraFormer.py:99-140``): ``linears`` are q, k, v, out."""

    def __init__(self, d_model: int, num_heads: int, dropout_rate: float = 0.1):
        super().__init__()
        assert d_model % num_heads == 0, "d_model must divide num_heads"
        self.num_heads = num_heads
        self.linears = nn.ModuleList([TorchDense(d_model, d_model) for _ in range(4)])
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, n, d = x.shape
        h = self.num_heads
        dk = d // h
        q, k, v = (lin(x).reshape(b, n, h, dk).transpose(1, 2) for lin in self.linears[:3])
        scores = q @ k.transpose(-1, -2) / math.sqrt(dk)
        if mask is not None:
            scores = scores.masked_fill(mask[:, None] == 0, -1e9)
        probs = self.dropout(torch.softmax(scores, dim=-1))
        out = (probs @ v).transpose(1, 2).reshape(b, n, d)
        return self.linears[3](out)


class PositionwiseFeedForward(nn.Module):
    """Transformer FFN ``w_2(dropout(relu(w_1(x))))`` (reference
    ``models/GraFormer.py:143-155``)."""

    def __init__(self, d_model: int, d_ff: int, dropout_rate: float = 0.1):
        super().__init__()
        self.w_1 = TorchDense(d_model, d_ff)
        self.w_2 = TorchDense(d_ff, d_model)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w_2(self.dropout(F.relu(self.w_1(x))))


class LAMGconv(nn.Module):
    """One learned-adjacency graph conv ``fc(L·X)`` (reference ``LAM_Gconv``)."""

    def __init__(self, in_features: int, out_features: int, relu: bool):
        super().__init__()
        self.fc = TorchDense(in_features, out_features)
        self.relu = relu

    def forward(self, x: torch.Tensor, lap: torch.Tensor) -> torch.Tensor:
        x = self.fc(lap @ x)
        return F.relu(x) if self.relu else x


class GraphNet(nn.Module):
    """Learned-adjacency two-layer GCN, hidden width 2× input.

    ``A_hat`` starts as the identity and is sym-normalized with column-sum
    degrees + 1e-5 on every call (reference ``models/GraFormer.py:162-201``).
    """

    def __init__(self, in_features: int, features: int, n_pts: int):
        super().__init__()
        self.A_hat = nn.Parameter(torch.eye(n_pts))
        self.gconv1 = LAMGconv(in_features, 2 * in_features, relu=True)
        self.gconv2 = LAMGconv(2 * in_features, features, relu=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        lap = learned_adjacency_laplacian(self.A_hat).to(x.dtype)
        return self.gconv2(self.gconv1(x, lap), lap)


class SublayerConnection(nn.Module):
    """``x + dropout(fn(norm(x)))`` (reference ``SublayerConnection``)."""

    def __init__(self, dim: int, dropout_rate: float):
        super().__init__()
        self.norm = TorchStyleLayerNorm(dim)
        self.dropout = nn.Dropout(dropout_rate)

    def forward(self, x: torch.Tensor, fn) -> torch.Tensor:
        return x + self.dropout(fn(self.norm(x)))


class GraAttenLayer(nn.Module):
    """Pre-LN residual attention, then the GraphNet "FFN" (reference
    ``models/GraFormer.py:73-96``)."""

    def __init__(self, dim_model: int, num_heads: int, n_pts: int,
                 dropout_rate: float = 0.25, attn_dropout_rate: float = 0.1):
        super().__init__()
        self.self_attn = MultiHeadAttention(dim_model, num_heads, attn_dropout_rate)
        self.feed_forward = GraphNet(dim_model, dim_model, n_pts)
        self.sublayer = nn.ModuleList(
            [SublayerConnection(dim_model, dropout_rate) for _ in range(2)])

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        x = self.sublayer[0](x, lambda y: self.self_attn(y, mask))
        return self.sublayer[1](x, self.feed_forward)


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Sinusoidal timestep embedding: ``freqs = exp(−log(10000)·i/(half−1))``,
    ``concat(sin, cos)``, zero-padded if ``dim`` is odd (reference
    ``get_timestep_embedding``, ``models/gcndiff.py:15-33``)."""
    assert t.ndim == 1
    half = dim // 2
    freqs = torch.exp(
        torch.arange(half, dtype=torch.float32, device=t.device)
        * -(math.log(10000.0) / (half - 1)))
    args = t.to(torch.float32)[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepMLP(nn.Module):
    """Timestep embedding → ``dense.0`` → swish → ``dense.1`` (reference
    ``temb`` block of ``GCNdiff``)."""

    def __init__(self, hid_dim: int, emd_dim: int):
        super().__init__()
        self.hid_dim = hid_dim
        self.dense = nn.ModuleList([TorchDense(hid_dim, emd_dim), TorchDense(emd_dim, emd_dim)])

    def forward(self, t: torch.Tensor) -> torch.Tensor:
        temb = timestep_embedding(t, self.hid_dim)
        return self.dense[1](F.silu(self.dense[0](temb)))


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      mask: Optional[torch.Tensor] = None, chunk_size: int = 128,
                      scale: Optional[float] = None) -> torch.Tensor:
    """Query-chunked scaled-dot-product attention (counterpart of
    ``diffpose_tpu/models/layers.py:chunked_attention``): query chunks of
    ``chunk_size`` against the full K/V, so the whole score matrix never
    exists at once.

    ``q, k, v``: ``[B, H, S, D]``; ``mask`` broadcastable to ``[B, H, S, S_k]``,
    0 where masked (filled with −1e9).  A query length that is not a multiple
    of the chunk is zero-padded up to one and the padded mask rows are 1s,
    so that no row is all masked; the padded rows are dropped.  ``scale``
    defaults to 1/√D (pass 1.0 where q carries it already).
    """
    b, h, s, d = q.shape
    sk = k.shape[2]
    scale = 1.0 / math.sqrt(d) if scale is None else scale

    def attend(qc, m):
        scores = torch.einsum("bhnd,bhmd->bhnm", qc, k) * scale
        if m is not None:
            scores = scores.masked_fill(m == 0, -1e9)
        return torch.einsum("bhnm,bhmd->bhnd", torch.softmax(scores, dim=-1), v)

    if s <= chunk_size:
        return attend(q, mask)
    pad = (-s) % chunk_size
    q = F.pad(q, (0, 0, 0, pad))
    if mask is not None:
        mask = torch.broadcast_to(mask, (b, h, s, sk))
        mask = torch.cat([mask, mask.new_ones((b, h, pad, sk))], dim=2)
    out = torch.cat([attend(q[:, :, i:i + chunk_size],
                            None if mask is None else mask[:, :, i:i + chunk_size])
                     for i in range(0, s + pad, chunk_size)], dim=2)
    return out[:, :, :s]
