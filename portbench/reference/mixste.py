"""The MixSTE video denoiser and its evaluation batch, in plain PyTorch.

Written from the published model, not from the program: MixSTE (Zhang et
al., CVPR 2022, arXiv 2203.00859; ``common/model_cross.py:MixSTE2`` of
github.com/JinluZhang1126/MixSTE) with what DiffPose's use adds (uvxyz in
and out, the timestep MLP added to every token), in evaluation (no dropout,
no stochastic depth).  Per window ``x [F, J, C]``:

    h = W_in x + P_s[j] + temb(t)
    for i in 0 .. depth-1:
        h = Spatial_norm(STE_i(h))          over the J tokens of each frame
        h += P_t[f]                         (i = 0 only)
        h = Temporal_norm(TTE_i(h))         over the F tokens of each joint
    eps = W_out LN(h)

a block being ``h + attn(LN1 h)``, then ``h + W2 gelu(W1 LN2 h)``.  The
weights are a dict named as MixSTE2's ``state_dict`` keys; every operation
is a plain torch call in the inputs' dtype (the check uses float64), one
block of windows at a time.  ``eval_batch`` is the video protocol around it
(``protocol.py``'s GMM draw, DDIM and errors): a per-frame GMM draw of the
2D input, a zero xyz start, DDIM over the window, the hypothesis mean.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import protocol
from portbench.reference.nets import Params, linear, timestep_embedding

HEAD_LN_EPS = 1e-5         # MixSTE2's head: nn.LayerNorm(embed_dim), torch's default eps


def layer_norm(p: Params, name: str, x: torch.Tensor, eps: float) -> torch.Tensor:
    """``w·(x−μ)/√(var+eps)+b``, the biased variance (``nn.LayerNorm``)."""
    mean = x.mean(dim=-1, keepdim=True)
    c = x - mean
    return p[f"{name}.weight"] * c / torch.sqrt((c * c).mean(dim=-1, keepdim=True) + eps) + p[f"{name}.bias"]


def gelu(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def softmax(s: torch.Tensor) -> torch.Tensor:
    e = torch.exp(s - s.max(dim=-1, keepdim=True).values)
    return e / e.sum(dim=-1, keepdim=True)


def attention(p: Params, name: str, x: torch.Tensor, heads: int) -> torch.Tensor:
    """Self-attention over the second axis of ``x [N, S, D]``: ``qkv`` (one
    projection, biased), scores scaled by ``(D/heads)^-1/2``, ``proj``."""
    n, s, d = x.shape
    q, k, v = linear(p, f"{name}.qkv", x).reshape(n, s, 3, heads, d // heads).permute(2, 0, 3, 1, 4)
    probs = softmax(q @ k.transpose(-1, -2) * (d // heads) ** -0.5)
    return linear(p, f"{name}.proj", (probs @ v).transpose(1, 2).reshape(n, s, d))


def block(p: Params, name: str, x: torch.Tensor, heads: int, eps: float) -> torch.Tensor:
    x = x + attention(p, f"{name}.attn", layer_norm(p, f"{name}.norm1", x, eps), heads)
    h = gelu(linear(p, f"{name}.mlp.fc1", layer_norm(p, f"{name}.norm2", x, eps)))
    return x + linear(p, f"{name}.mlp.fc2", h)


def forward(p: Params, x: torch.Tensor, t: torch.Tensor, *, depth: int, heads: int,
            ln_eps: float) -> torch.Tensor:
    """ε̂ for ``x [B, F, J, C]`` at timesteps ``t [B]``."""
    b, f, j, _ = x.shape
    d = p["Spatial_pos_embed"].shape[-1]
    temb = timestep_embedding(t, d)
    temb = linear(p, "temb_dense_1", torch.nn.functional.silu(linear(p, "temb_dense_0", temb)))
    h = linear(p, "Spatial_patch_to_embedding", x) + p["Spatial_pos_embed"] + temb[:, None, None, :]
    h = h.reshape(b * f, j, d)
    for i in range(depth):
        h = layer_norm(p, "Spatial_norm", block(p, f"STEblocks.{i}", h, heads, ln_eps), ln_eps)
        h = h.reshape(b, f, j, d).transpose(1, 2).reshape(b * j, f, d)
        if i == 0:
            h = h + p["Temporal_pos_embed"]
        h = layer_norm(p, "Temporal_norm", block(p, f"TTEblocks.{i}", h, heads, ln_eps), ln_eps)
        h = h.reshape(b, j, f, d).transpose(1, 2).reshape(b * f, j, d)
    out = linear(p, "head.1", layer_norm(p, "head.0", h, HEAD_LN_EPS))
    return out.reshape(b, f, j, -1)


def forward_blocks(p: Params, x: torch.Tensor, t: torch.Tensor, windows: int, **arch) -> torch.Tensor:
    """:func:`forward` ``windows`` windows at a time, so that the float64
    activations and scores of a whole batch need not fit at once."""
    return torch.cat([forward(p, x[i:i + windows], t[i:i + windows], **arch)
                      for i in range(0, x.shape[0], windows)])


def frame_ids(seeds: np.ndarray, frames: int) -> np.ndarray:
    """The GMM key of frame ``f`` of a window with per-sample id ``s``:
    ``s·F + f``, wrapped to int32."""
    ids = np.asarray(seeds, np.int64)[:, None] * frames + np.arange(frames)[None, :]
    return ((ids.reshape(-1) + (1 << 31)) % (1 << 32) - (1 << 31)).astype(np.int32)


def eval_batch(p: Params, data: dict, rows: np.ndarray, cfg: dict, device) -> dict:
    """``p``: float64 weights; ``data``: the split's windows (``poses_3d [W,
    F, J, 3]``, ``poses_2d_gmm [W, F, J, K, 5]``); ``rows``: the batch's
    windows; ``cfg``: depth, heads, ln_eps, test_times, seq, betas,
    loader_seed, windows (the reference's block).  Returns pred ``[B, F, J,
    3]`` and p1, p2 ``[B, F]`` (metres) as numpy float64."""
    gmm = torch.as_tensor(data["poses_2d_gmm"][rows], device=device)
    p3 = torch.as_tensor(data["poses_3d"][rows], device=device).double()
    b, f, j, k, _ = gmm.shape
    ids = torch.as_tensor(frame_ids(protocol.sample_ids(rows, seed=cfg["loader_seed"]), f),
                          device=device)
    flat = gmm.reshape(b * f, j, k, 5)
    uv, _ = protocol.gmm_kernels(flat, protocol.gmm_choice_per_sample(0, ids, flat))
    uv = uv.double().reshape(b, f, j, 2)
    x = torch.cat([uv, torch.zeros((b, f, j, 3), dtype=uv.dtype, device=device)], dim=-1)
    x = x.repeat(cfg["test_times"], 1, 1, 1)
    arch = dict(depth=cfg["depth"], heads=cfg["heads"], ln_eps=cfg["ln_eps"])
    out = protocol.ddim(lambda z, t: forward_blocks(p, z, t, cfg["windows"], **arch), x,
                        cfg["seq"], cfg["betas"])
    out = out.reshape(cfg["test_times"], b, f, j, 5).mean(dim=0)
    pred = (out[..., 2:] - out[..., :1, 2:]).cpu().numpy()
    target = (p3 - p3[..., :1, :]).cpu().numpy()
    flat_pred, flat_target = pred.reshape(b * f, j, 3), target.reshape(b * f, j, 3)
    return dict(pred=pred, p1=protocol.mpjpe(flat_pred, flat_target).reshape(b, f),
                p2=protocol.p_mpjpe(flat_pred, flat_target).reshape(b, f))
