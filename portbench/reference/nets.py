"""Plain PyTorch forwards of the benchmarked networks, on a dict of weights.

Written from the published models, not from the program: the frame
denoiser GCNdiff and the lifter GCNpose of DiffPose
(``models/gcndiff.py``, ``models/gcnpose.py`` of the reference, built from
``models/ChebConv.py`` and ``models/GraFormer.py``), in evaluation (no
dropout).  The weights are a dict named as the models' ``state_dict`` keys;
every operation is a plain torch call in the dtype of the inputs (the checks
use float64), with no kernel, cache or batching trick.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

Params = Dict[str, torch.Tensor]


def cheb_conv(p: Params, name: str, x: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """``Σ_k T_k · x · W_k + b`` with ``W [K+1, 1, C, D]``, ``b [1, 1, D]``."""
    xk = torch.einsum("knm,bmc->bnkc", basis, x)
    return torch.einsum("bnkc,kcd->bnd", xk, p[f"{name}.weight"][:, 0]) + p[f"{name}.bias"].reshape(-1)


def linear(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    return x @ p[f"{name}.weight"].t() + p[f"{name}.bias"]


def layer_norm(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """``a·(x−μ)/(σ+1e-6)+b``, σ with Bessel's correction (GraFormer's LayerNorm)."""
    mean = x.mean(dim=-1, keepdim=True)
    c = x - mean
    sigma = torch.sqrt((c * c).sum(dim=-1, keepdim=True) / (x.shape[-1] - 1))
    return p[f"{name}.a_2"] * c / (sigma + 1e-6) + p[f"{name}.b_2"]


def attention(p: Params, name: str, x: torch.Tensor, heads: int) -> torch.Tensor:
    """Multi-head scaled dot-product self-attention over the second axis of
    ``x [B, S, D]``; projections ``name.0`` to ``name.3``: q, k, v, output."""
    b, s, d = x.shape
    dk = d // heads

    def split(z):
        return z.reshape(b, s, heads, dk).transpose(1, 2)

    q, k, v = (split(linear(p, f"{name}.{n}", x)) for n in range(3))
    probs = torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(dk), dim=-1)
    out = (probs @ v).transpose(1, 2).reshape(b, s, d)
    return linear(p, f"{name}.3", out)


def graph_net(p: Params, name: str, x: torch.Tensor) -> torch.Tensor:
    """GraFormer's learned-adjacency GCN: ``fc2(L·relu(fc1(L·x)))`` with
    ``L = D^-1/2 Â D^-1/2``, ``D`` the column sums of ``Â`` plus 1e-5."""
    a = p[f"{name}.A_hat"]
    d = (a.sum(dim=-2) + 1e-5) ** -0.5
    lap = d[:, None] * a * d[None, :]
    h = F.relu(linear(p, f"{name}.gconv1.fc", lap @ x))
    return linear(p, f"{name}.gconv2.fc", lap @ h)


def gra_atten_layer(p: Params, name: str, x: torch.Tensor, heads: int) -> torch.Tensor:
    """Pre-LN residual attention, then the pre-LN residual GraphNet."""
    x = x + attention(p, f"{name}.self_attn.linears", layer_norm(p, f"{name}.sublayer.0.norm", x),
                      heads)
    return x + graph_net(p, f"{name}.feed_forward", layer_norm(p, f"{name}.sublayer.1.norm", x))


def res_cheb(p: Params, name: str, x: torch.Tensor, basis: torch.Tensor,
             temb: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``x + relu(cheb2(relu(cheb1(x)) [+ W·swish(temb)]))``."""
    h = F.relu(cheb_conv(p, f"{name}.gconv1.gconv", x, basis))
    if temb is not None:
        h = h + linear(p, f"{name}.temb_proj", F.silu(temb))[:, None, :]
    return x + F.relu(cheb_conv(p, f"{name}.gconv2.gconv", h, basis))


def timestep_embedding(t: torch.Tensor, dim: int) -> torch.Tensor:
    """``concat(sin(t·f), cos(t·f))``, ``f_i = exp(−ln(10⁴)·i/(dim/2 − 1))``."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=t.dtype, device=t.device)
                      * -(math.log(10000.0) / (half - 1)))
    args = t[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], dim=-1)
    return F.pad(emb, (0, 1)) if dim % 2 else emb


def gcn_diff(p: Params, x: torch.Tensor, t: torch.Tensor, basis: torch.Tensor, *, hid: int,
             layers: int, heads: int) -> torch.Tensor:
    """GCNdiff: ε̂ for ``x [B, N, C]`` at timesteps ``t [B]``."""
    temb = timestep_embedding(t, hid)
    temb = linear(p, "temb.dense.1", F.silu(linear(p, "temb.dense.0", temb)))
    h = cheb_conv(p, "gconv_input", x, basis)
    for i in range(layers):
        h = gra_atten_layer(p, f"atten_layers.{i}", h, heads)
        h = res_cheb(p, f"gconv_layers.{i}", h, basis, temb)
    return cheb_conv(p, "gconv_output", h, basis)


def gcn_pose(p: Params, x: torch.Tensor, basis: torch.Tensor, *, layers: int,
             heads: int) -> torch.Tensor:
    """GCNpose: the 3D pose ``[B, N, 3]`` lifted from ``x [B, N, 2]``."""
    h = cheb_conv(p, "gconv_input", x, basis)
    for i in range(layers):
        h = gra_atten_layer(p, f"atten_layers.{i}", h, heads)
        h = res_cheb(p, f"gconv_layers.{i}", h, basis)
    return cheb_conv(p, "gconv_output", h, basis)
