"""The video denoiser's training forward with every spatial block on the train
kernel pair (kernel rows 5–6, or 7–8 with seeded dropout) at ``B·F`` rows.

Counterpart of ``diffpose_tpu/ops/pallas_video_train.py``.  Each spatial
block (GraAttenLayer + ResChebGCDiff per frame, ``models/video.py:179-190``)
is a one-layer instance of the frame family's train stack
(``ops/fused_train.py:build_train_stack``: one forward and one backward
launch per block and step, behind an ``autograd.Function``) at the video
dropout rates (:func:`video_dropout_rates`).  The rest is torch under
autograd: the timestep MLP, the positional embedding, the I/O ChebConvs and
the temporal blocks (:func:`temporal_block_train`, the module's three
dropout sites with explicit masks).

Dropout: ``dropout="masks"`` hands the stack ``DropoutMasks`` drawn at
``B·F`` rows for all layers (sliced per layer); ``"prng"`` hands it one
``int32[1]`` step seed, and layer ``i`` draws from ``seed + i·1000003``
(int32 wrap-around), because every one-layer stack runs as kernel layer 0
(``pallas_video_train.py:236``).  The temporal masks are drawn from the
step's generator or handed in (:func:`make_temporal_masks`).

Deliberate difference: the TPU version zero-pads the ``B·F`` rows to its
kernels' tile (``pallas_video_train.py:199-247``); the CUDA kernels mask a
ragged last tile themselves, so nothing is padded here.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from diffpose_tpu_torch.ops.fused_denoiser import _cheb, prepare_weights
from diffpose_tpu_torch.ops.fused_train import build_train_stack
from diffpose_tpu_torch.ops.fused_video_full import (
    SpatialBlocks,
    from_rows,
    layer_weights,
    spatial_projections,
    to_rows,
)
from diffpose_tpu_torch.ops.philox import philox_masks
from diffpose_tpu_torch.ops.tf32 import PARITY_TIER
from diffpose_tpu_torch.ops.train_ref import (
    RATE_ATTN_PROBS,
    RATE_CHEB,
    DropoutMasks,
    layers_forward,
)

LAYER_SEED_STRIDE = 1000003


def video_dropout_rates(model) -> Tuple[float, float, float]:
    """``(p_attn_probs, p_sublayer, p_cheb)`` of the spatial blocks: the
    attention probabilities keep GraAttenLayer's 0.1, the sublayer rate is the
    model's ``dropout_rate``, the Chebyshev blocks are built with 0.1."""
    return (RATE_ATTN_PROBS, float(model.dropout_rate), RATE_CHEB)


def wrap_int32(v: torch.Tensor) -> torch.Tensor:
    """Integers as int32 with two's-complement wrap-around."""
    return ((v.to(torch.int64) + (1 << 31)) % (1 << 32) - (1 << 31)).to(torch.int32)


def layer_seed(seed: torch.Tensor, layer: int) -> torch.Tensor:
    """``seed + layer·1000003`` with int32 wrap-around, on ``seed``'s device."""
    return wrap_int32(seed.to(torch.int64) + layer * LAYER_SEED_STRIDE)


class TemporalMasks(NamedTuple):
    """0/1 masks of the temporal blocks' three dropout sites, over layers."""

    probs: torch.Tensor      # [L, N, heads, F, F]
    attn_out: torch.Tensor   # [L, N, F, H]
    ff_out: torch.Tensor     # [L, N, F, H]


def make_temporal_masks(generator: torch.Generator, *, num_layers: int, rows: int, frames: int,
                        num_heads: int, hid_dim: int, rate: float,
                        dtype=torch.uint8) -> TemporalMasks:
    """Bernoulli(1 − rate) masks of every temporal site of one step, for
    ``rows = B·J`` rows, on the generator's device."""
    def bern(shape):
        u = torch.rand(shape, generator=generator, device=generator.device)
        return (u < 1.0 - rate).to(dtype)

    return TemporalMasks(bern((num_layers, rows, num_heads, frames, frames)),
                         bern((num_layers, rows, frames, hid_dim)),
                         bern((num_layers, rows, frames, hid_dim)))


def _drop(x: torch.Tensor, mask: Optional[torch.Tensor], rate: float) -> torch.Tensor:
    """Flax ``nn.Dropout``: ``where(mask, x / keep, 0)``."""
    if rate <= 0.0:
        return x
    return torch.where(mask.bool(), x / (1.0 - rate), torch.zeros((), dtype=x.dtype,
                                                                   device=x.device))


def temporal_block_train(block, x: torch.Tensor, rate: float,
                         masks: Optional[Tuple[torch.Tensor, ...]] = None) -> torch.Tensor:
    """Training-mode TemporalBlock on ``x [N, F, H]`` from the module's
    parameters, differentiable with respect to them
    (``pallas_video_train.py:92``): the materialised scores with dropout on
    the probabilities, then on the attention's and the feed-forward's
    outputs.  ``masks``: the layer's ``(probs, attn_out, ff_out)``; unused at
    rate 0."""
    n, f, d = x.shape
    heads = block.attn.num_heads
    dk = d // heads
    m_probs, m_attn, m_ff = masks if masks is not None else (None, None, None)

    def split(z):
        return z.reshape(n, f, heads, dk).transpose(1, 2)

    y = block.norm1(x)
    q, k, v = split(block.attn.q(y)), split(block.attn.k(y)), split(block.attn.v(y))
    probs = _drop(torch.softmax(q @ k.transpose(-1, -2) / math.sqrt(dk), dim=-1), m_probs, rate)
    att = (probs @ v).transpose(1, 2).reshape(n, f, d)
    x = x + _drop(block.attn.out(att), m_attn, rate)
    y = block.ff2(F.relu(block.ff1(block.norm2(x))))
    return x + _drop(y, m_ff, rate)


def plain_stack(rates):
    """The train pair's function in tensor operations under autograd
    (``train_ref.layers_forward``), taking explicit masks or, as the seeded
    pair does, a seed whose masks it draws with ``philox_masks``."""
    def stack(w, h0, tp, masks):
        if isinstance(masks, torch.Tensor):
            masks = philox_masks(masks, num_layers=w["num_layers"], batch=h0.shape[0],
                                 n_pts=w["n_pts"], num_heads=w["num_heads"],
                                 hid_dim=w["hid_dim"], rates=rates, device=h0.device,
                                 dtype=h0.dtype)
        return layers_forward(w, h0, tp, masks, rates=rates)

    return stack


def make_video_train_fn(model, *, dropout: str = "masks", rates=None, stack_fn=None,
                        tier: str = PARITY_TIER, plain: bool = False):
    """Build ``fn(x [B, F, J, 5], t [B], masks_or_seed, tmasks) → ε̂``, the
    training forward of ``model`` (a ``SpatioTemporalDiff``) with its spatial
    blocks on the train kernel pair, differentiable with respect to the
    module's parameters.  Counterpart of ``make_pallas_video_train_fn``.

    ``masks_or_seed``: ``DropoutMasks`` at ``B·F`` rows for all layers
    (``dropout="masks"``) or the ``int32[1]`` step seed (``"prng"``);
    ``tmasks``: :class:`TemporalMasks`, or None at a temporal rate of 0.
    ``stack_fn(w, h0, tp, masks_or_seed)`` replaces the kernel pair
    (:func:`plain_stack` for the plain twin).  ``tier``: the kernel pair's
    ``--kernel_precision``; ``plain``: its plain tier versions behind the
    same autograd function (``build_train_stack(..., plain=True)``, the plain
    step at a reduced tier).  The temporal blocks stay torch operations at
    the ambient matmul grade at every tier, as in
    ``pallas_video_train.py:92``.
    """
    if dropout not in ("masks", "prng"):
        raise ValueError(f"dropout must be 'masks' or 'prng', got {dropout!r}")
    prng = dropout == "prng"
    rates = rates or video_dropout_rates(model)
    t_rate = float(model.dropout_rate)
    blocks = SpatialBlocks(model)
    if stack_fn is None:
        stack_fn = build_train_stack(blocks.gconv_input.basis.numpy(), num_layers=1,
                                     num_heads=model.num_heads, hid_dim=model.hid_dim,
                                     rates=rates, dropout=dropout, tier=tier, plain=plain)

    def fn(x: torch.Tensor, t: torch.Tensor, masks, tmasks: Optional[TemporalMasks] = None):
        b, f, j, c = x.shape
        if f != model.frames:
            raise ValueError(f"the model takes {model.frames}-frame windows, got {f}")
        if t_rate > 0 and tmasks is None:
            raise ValueError(f"a temporal dropout rate of {t_rate} needs the temporal masks")
        sw = prepare_weights(blocks, x.device, differentiable=True)
        lw = layer_weights(sw)
        tps = spatial_projections(sw, t, f)
        h = _cheb(x.reshape(b * f, j, c), sw["win"], sw["bin"], sw["basis"]).reshape(b, f, j, -1)
        h = h + model.pos_embed[None, :, None, :]
        for i in range(model.num_layers):
            mk = layer_seed(masks, i) if prng else DropoutMasks(*(m[i:i + 1] for m in masks))
            d5 = stack_fn(lw[i], h.reshape(b * f, j, -1), tps[i], mk).reshape(h.shape)
            tm = None if tmasks is None else tuple(m[i] for m in tmasks)
            h = from_rows(temporal_block_train(model.layer(i)[2], to_rows(d5), t_rate, tm), b)
        out = _cheb(h.reshape(b * f, j, -1), sw["wout"], sw["bout"], sw["basis"])
        return out.reshape(b, f, j, -1)

    return fn

